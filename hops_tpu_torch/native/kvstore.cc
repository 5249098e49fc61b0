// Embedded key-value store: the native engine behind the online feature
// store (hops_tpu/featurestore/online.py).
//
// The reference's online store was MySQL Cluster (NDB) reached over JDBC
// prepared statements (SURVEY.md §2.6 — "implied native"). This is the
// TPU build's equivalent: a log-structured store with an in-memory hash
// index, giving O(1) point lookups for `get_serving_vector` without a
// database server.
//
// Format: append-only log of records
//   [u32 klen][u32 vlen][key][value]        (vlen == 0xFFFFFFFF: tombstone)
// On open the log is scanned once to rebuild the index; `compact`
// rewrites the log with only live records.
//
// C ABI only (consumed via ctypes — no pybind11 in the image).

#include <sys/mman.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;

struct Entry {
  uint64_t offset;  // offset of the value bytes in the log
  uint32_t length;
};

struct Store {
  std::FILE* f = nullptr;
  std::string path;
  std::unordered_map<std::string, Entry> index;
  uint64_t end = 0;  // current append offset
  std::mutex mu;
  // Read-only mmap of the log: point lookups are a hash probe plus a
  // memcpy out of the mapping instead of fseek+fread per key (the
  // fseek path measured ~2x SLOWER than sqlite's batched SELECT; the
  // mapping is what makes the native engine the fast online backend).
  // Remapped lazily when the log outgrows it; `flushed` tracks how far
  // the stdio stream has been pushed into the file — a MAP_SHARED
  // mapping sees file bytes, never the stream's private buffer.
  char* map = nullptr;
  uint64_t map_len = 0;
  uint64_t flushed = 0;
};

void drop_mapping(Store* s) {
  if (s->map != nullptr) munmap(s->map, s->map_len);
  s->map = nullptr;
  s->map_len = 0;
}

// Make [0, s->end) readable through s->map. Caller holds s->mu.
// Returns false when the log is empty or mmap fails (callers fall back
// to the fseek+fread path).
bool ensure_mapped(Store* s) {
  if (s->flushed < s->end) {
    std::fflush(s->f);
    s->flushed = s->end;
  }
  if (s->map != nullptr && s->map_len >= s->end) return true;
  drop_mapping(s);
  if (s->end == 0) return false;  // empty log: nothing to map
  // Map the whole file (it may exceed `end` only transiently); the
  // file can only grow, so headroom beyond `end` stays valid.
  std::fseek(s->f, 0, SEEK_END);
  uint64_t file_size = (uint64_t)std::ftell(s->f);
  if (file_size < s->end) return false;
  void* m = mmap(nullptr, file_size, PROT_READ, MAP_SHARED, fileno(s->f), 0);
  if (m == MAP_FAILED) return false;
  s->map = (char*)m;
  s->map_len = file_size;
  return true;
}

bool read_exact(std::FILE* f, void* buf, size_t n) {
  return std::fread(buf, 1, n, f) == n;
}

// Scan the log, rebuilding the index. A torn tail record (crash mid-
// write) is detected by bounds-checking against the real file size —
// fseek past EOF "succeeds", so size is the only reliable signal.
bool rebuild_index(Store* s) {
  std::fseek(s->f, 0, SEEK_END);
  uint64_t file_size = (uint64_t)std::ftell(s->f);
  std::fseek(s->f, 0, SEEK_SET);
  uint64_t pos = 0;
  std::vector<char> kbuf;
  for (;;) {
    uint32_t hdr[2];
    if (pos + sizeof hdr > file_size) break;
    if (!read_exact(s->f, hdr, sizeof hdr)) break;
    uint32_t klen = hdr[0], vlen = hdr[1];
    if (pos + sizeof hdr + klen > file_size) break;
    kbuf.resize(klen);
    if (!read_exact(s->f, kbuf.data(), klen)) break;
    std::string key(kbuf.data(), klen);
    if (vlen == kTombstone) {
      s->index.erase(key);
      pos += sizeof hdr + klen;
    } else {
      uint64_t voff = pos + sizeof hdr + klen;
      if (voff + vlen > file_size) break;  // torn value: drop tail record
      s->index[key] = Entry{voff, vlen};
      pos = voff + vlen;
      std::fseek(s->f, (long)pos, SEEK_SET);
    }
  }
  s->end = pos;
  s->flushed = pos;  // everything scanned is already in the file
  if (pos < file_size) {
    // Torn tail: cut it off. Leaving the garbage in place would let a
    // shorter subsequent append partially overwrite it, and the NEXT
    // reopen could then parse the leftover bytes as phantom records.
    std::fflush(s->f);
    if (ftruncate(fileno(s->f), (off_t)pos) != 0) return false;
  }
  return true;
}

int append_record(Store* s, const char* k, uint32_t klen, const char* v,
                  uint32_t vlen) {
  std::fseek(s->f, (long)s->end, SEEK_SET);
  uint32_t hdr[2] = {klen, vlen};
  if (std::fwrite(hdr, 1, sizeof hdr, s->f) != sizeof hdr) return -1;
  if (std::fwrite(k, 1, klen, s->f) != klen) return -1;
  uint64_t voff = s->end + sizeof hdr + klen;
  if (vlen != kTombstone && vlen > 0) {
    if (std::fwrite(v, 1, vlen, s->f) != vlen) return -1;
  }
  if (vlen == kTombstone) {
    s->index.erase(std::string(k, klen));
    s->end = voff;
  } else {
    s->index[std::string(k, klen)] = Entry{voff, vlen};
    s->end = voff + vlen;
  }
  return 0;
}

struct ScanIter {
  Store* store;
  std::vector<std::string> keys;
  size_t pos = 0;
};

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  auto* s = new Store();
  s->path = path;
  s->f = std::fopen(path, "r+b");
  if (!s->f) s->f = std::fopen(path, "w+b");
  if (!s->f) {
    delete s;
    return nullptr;
  }
  rebuild_index(s);
  return s;
}

int kv_put(void* h, const char* k, uint32_t klen, const char* v,
           uint32_t vlen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return append_record(s, k, klen, v, vlen);
}

// Copy one entry's value bytes into `dst`. Caller holds s->mu. Serves
// from the mmap when available (hash probe + memcpy — the hot path),
// else falls back to fseek+fread.
bool read_value(Store* s, const Entry& e, char* dst) {
  if (ensure_mapped(s) && e.offset + e.length <= s->map_len) {
    std::memcpy(dst, s->map + e.offset, e.length);
    return true;
  }
  std::fseek(s->f, (long)e.offset, SEEK_SET);
  return read_exact(s->f, dst, e.length);
}

// On hit: *out is malloc'd (caller frees via kv_free), returns 0. Miss: -1.
int kv_get(void* h, const char* k, uint32_t klen, char** out,
           uint32_t* out_len) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->index.find(std::string(k, klen));
  if (it == s->index.end()) return -1;
  char* buf = (char*)std::malloc(it->second.length + 1);
  if (!read_value(s, it->second, buf)) {
    std::free(buf);
    return -2;
  }
  buf[it->second.length] = 0;
  *out = buf;
  *out_len = it->second.length;
  return 0;
}

// Batched point lookup — the online store's multi-get hot path. `keys`
// is n records of [u32 klen][key bytes]; the reply is ONE malloc'd
// buffer of n records [u32 vlen][value bytes] in input order, with
// vlen == 0xFFFFFFFF (and no bytes) for a miss. One FFI crossing and
// one lock acquisition amortize over the whole batch — the per-key
// ctypes + mutex cost was most of a native point lookup.
int kv_get_many(void* h, const char* keys, uint32_t nkeys, char** out,
                uint64_t* out_len) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  // Pass 1: resolve entries and size the reply buffer.
  std::vector<const Entry*> hits(nkeys, nullptr);
  uint64_t total = 0;
  const char* p = keys;
  for (uint32_t i = 0; i < nkeys; ++i) {
    uint32_t klen;
    std::memcpy(&klen, p, sizeof klen);
    p += sizeof klen;
    auto it = s->index.find(std::string(p, klen));
    p += klen;
    total += sizeof(uint32_t);
    if (it != s->index.end()) {
      hits[i] = &it->second;
      total += it->second.length;
    }
  }
  char* buf = (char*)std::malloc(total ? total : 1);
  if (!buf) return -1;
  char* w = buf;
  for (uint32_t i = 0; i < nkeys; ++i) {
    if (!hits[i]) {
      uint32_t miss = kTombstone;
      std::memcpy(w, &miss, sizeof miss);
      w += sizeof miss;
      continue;
    }
    uint32_t vlen = hits[i]->length;
    std::memcpy(w, &vlen, sizeof vlen);
    w += sizeof vlen;
    if (!read_value(s, *hits[i], w)) {
      std::free(buf);
      return -2;
    }
    w += vlen;
  }
  *out = buf;
  *out_len = total;
  return 0;
}

int kv_delete(void* h, const char* k, uint32_t klen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return append_record(s, k, klen, nullptr, kTombstone);
}

uint64_t kv_count(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->index.size();
}

void kv_flush(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::fflush(s->f);
  s->flushed = s->end;
}

// Rewrite the log with live records only; returns reclaimed bytes.
int64_t kv_compact(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string tmp_path = s->path + ".compact";
  std::FILE* tmp = std::fopen(tmp_path.c_str(), "w+b");
  if (!tmp) return -1;
  uint64_t old_end = s->end, pos = 0;
  std::unordered_map<std::string, Entry> new_index;
  std::vector<char> vbuf;
  for (auto& [key, e] : s->index) {
    vbuf.resize(e.length);
    std::fseek(s->f, (long)e.offset, SEEK_SET);
    if (!read_exact(s->f, vbuf.data(), e.length)) continue;
    uint32_t hdr[2] = {(uint32_t)key.size(), e.length};
    std::fwrite(hdr, 1, sizeof hdr, tmp);
    std::fwrite(key.data(), 1, key.size(), tmp);
    std::fwrite(vbuf.data(), 1, e.length, tmp);
    uint64_t voff = pos + sizeof hdr + key.size();
    new_index[key] = Entry{voff, e.length};
    pos = voff + e.length;
  }
  std::fflush(tmp);
  drop_mapping(s);  // the old file is about to be replaced
  std::fclose(s->f);
  if (std::rename(tmp_path.c_str(), s->path.c_str()) != 0) {
    std::fclose(tmp);
    s->f = std::fopen(s->path.c_str(), "r+b");
    s->flushed = 0;  // conservatively re-flush before the next mapping
    return -1;
  }
  s->f = tmp;
  s->index = std::move(new_index);
  s->end = pos;
  s->flushed = pos;
  return (int64_t)(old_end - pos);
}

void* kv_scan(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto* it = new ScanIter();
  it->store = s;
  it->keys.reserve(s->index.size());
  for (auto& [key, _] : s->index) it->keys.push_back(key);
  return it;
}

int kv_scan_next(void* iter, char** out, uint32_t* out_len) {
  auto* it = static_cast<ScanIter*>(iter);
  while (it->pos < it->keys.size()) {
    const std::string& key = it->keys[it->pos++];
    int rc = kv_get(it->store, key.data(), (uint32_t)key.size(), out, out_len);
    if (rc == 0) return 0;  // key may have been deleted since snapshot
  }
  return -1;
}

void kv_scan_close(void* iter) { delete static_cast<ScanIter*>(iter); }

void kv_free(char* p) { std::free(p); }

void kv_close(void* h) {
  auto* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    drop_mapping(s);
    std::fflush(s->f);
    std::fclose(s->f);
  }
  delete s;
}

}  // extern "C"
