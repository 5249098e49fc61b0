// Record-IO: length-prefixed record files with an offset index for O(1)
// random access — the native data-loader piece of the TPU build.
//
// The reference materialized training datasets as TFRecord files read by
// tf.data inside the Spark executors (training_datasets.ipynb:409-429,
// SURVEY.md §2.6); the heavy IO lived in TF's native ops. Here training
// datasets can materialize to this format and the feeder does shuffled
// per-record reads through this engine (ctypes), keeping the Python side
// to batch assembly only.
//
// Layout: <path>      = [u32 len][bytes]...
//         <path>.idx  = [u64 offset]... (offset of each record's header)

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Writer {
  std::FILE* f;
  std::string path;
  std::vector<uint64_t> offsets;
  uint64_t pos = 0;
};

struct Reader {
  std::FILE* f;
  int fd;  // for positioned (pread) batch reads
  std::vector<uint64_t> offsets;
  std::mutex mu;
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path) {
  auto* w = new Writer();
  w->path = path;
  w->f = std::fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  return w;
}

int rio_write(void* h, const char* data, uint32_t len) {
  auto* w = static_cast<Writer*>(h);
  uint32_t hdr = len;
  if (std::fwrite(&hdr, 1, sizeof hdr, w->f) != sizeof hdr) return -1;
  if (len && std::fwrite(data, 1, len, w->f) != len) return -1;
  w->offsets.push_back(w->pos);
  w->pos += sizeof hdr + len;
  return 0;
}

uint64_t rio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  std::fflush(w->f);
  std::fclose(w->f);
  uint64_t n = w->offsets.size();
  std::FILE* idx = std::fopen((w->path + ".idx").c_str(), "wb");
  if (idx) {
    std::fwrite(w->offsets.data(), sizeof(uint64_t), w->offsets.size(), idx);
    std::fclose(idx);
  }
  delete w;
  return n;
}

void* rio_reader_open(const char* path) {
  auto* r = new Reader();
  r->f = std::fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  std::string idx_path = std::string(path) + ".idx";
  std::FILE* idx = std::fopen(idx_path.c_str(), "rb");
  if (idx) {
    std::fseek(idx, 0, SEEK_END);
    long bytes = std::ftell(idx);
    std::fseek(idx, 0, SEEK_SET);
    r->offsets.resize((size_t)bytes / sizeof(uint64_t));
    if (std::fread(r->offsets.data(), 1, (size_t)bytes, idx) != (size_t)bytes)
      r->offsets.clear();
    std::fclose(idx);
  }
  if (r->offsets.empty()) {
    // No/torn index: rebuild by scanning the log.
    uint64_t pos = 0;
    for (;;) {
      uint32_t len;
      std::fseek(r->f, (long)pos, SEEK_SET);
      if (std::fread(&len, 1, sizeof len, r->f) != sizeof len) break;
      r->offsets.push_back(pos);
      pos += sizeof len + len;
    }
  }
  r->fd = fileno(r->f);
  return r;
}

uint64_t rio_num_records(void* h) {
  return static_cast<Reader*>(h)->offsets.size();
}

// *out malloc'd; free via rio_free.
int rio_read(void* h, uint64_t i, char** out, uint32_t* out_len) {
  auto* r = static_cast<Reader*>(h);
  std::lock_guard<std::mutex> lock(r->mu);
  if (i >= r->offsets.size()) return -1;
  std::fseek(r->f, (long)r->offsets[i], SEEK_SET);
  uint32_t len;
  if (std::fread(&len, 1, sizeof len, r->f) != sizeof len) return -2;
  char* buf = (char*)std::malloc(len ? len : 1);
  if (len && std::fread(buf, 1, len, r->f) != len) {
    std::free(buf);
    return -2;
  }
  *out = buf;
  *out_len = len;
  return 0;
}

void rio_free(char* p) { std::free(p); }

// Gather the records named by ``indices`` into ONE malloc'd buffer,
// packed back-to-back in the given order. Record lengths land in
// ``lens`` (caller-allocated, n entries); *out_total is the packed
// size. Positioned reads (pread) on the shared fd — thread-safe per
// POSIX, no seek contention, no mutex — fanned over ``n_threads``
// worker threads. This is the feeder's batch path: one ctypes call
// per training batch instead of one per record.
int rio_read_batch(void* h, const uint64_t* indices, uint32_t n,
                   uint32_t n_threads, char** out, uint64_t* out_total,
                   uint64_t* lens) {
  auto* r = static_cast<Reader*>(h);
  const uint64_t nrec = r->offsets.size();
  uint64_t total = 0;
  for (uint32_t i = 0; i < n; ++i) {
    const uint64_t idx = indices[i];
    if (idx >= nrec) return -1;
    if (idx + 1 < nrec) {
      // Records are contiguous, so consecutive offsets give the length
      // without touching the disk.
      if (r->offsets[idx + 1] < r->offsets[idx] + sizeof(uint32_t)) return -2;
      lens[i] = r->offsets[idx + 1] - r->offsets[idx] - sizeof(uint32_t);
    } else {
      // Only the final record needs its header consulted: a stale .idx
      // must not stretch it over trailing unindexed data.
      uint32_t hdr;
      if (pread(r->fd, &hdr, sizeof hdr, (off_t)r->offsets[idx]) !=
          (ssize_t)sizeof hdr)
        return -2;
      lens[i] = hdr;
    }
    total += lens[i];
  }
  char* buf = (char*)std::malloc(total ? total : 1);
  if (!buf) return -3;

  // Prefix positions of each record inside the packed buffer.
  std::vector<uint64_t> dst(n);
  uint64_t pos = 0;
  for (uint32_t i = 0; i < n; ++i) {
    dst[i] = pos;
    pos += lens[i];
  }

  const uint32_t workers =
      n_threads == 0 ? 1 : (n_threads < n ? n_threads : (n ? n : 1));
  std::vector<int> rcs(workers, 0);
  auto work = [&](uint32_t w) {
    for (uint32_t i = w; i < n; i += workers) {
      uint64_t remaining = lens[i];
      uint64_t src = r->offsets[indices[i]] + sizeof(uint32_t);
      char* d = buf + dst[i];
      while (remaining) {
        ssize_t got = pread(r->fd, d, remaining, (off_t)src);
        if (got <= 0) {
          rcs[w] = -4;
          return;
        }
        remaining -= (uint64_t)got;
        src += (uint64_t)got;
        d += got;
      }
    }
  };
  if (workers == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (uint32_t w = 0; w < workers; ++w) threads.emplace_back(work, w);
    for (auto& t : threads) t.join();
  }
  for (uint32_t w = 0; w < workers; ++w) {
    if (rcs[w] != 0) {
      std::free(buf);
      return rcs[w];
    }
  }
  *out = buf;
  *out_total = total;
  return 0;
}

void rio_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  std::fclose(r->f);
  delete r;
}

}  // extern "C"
