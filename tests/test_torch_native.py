"""The port's native engines (``hops_tpu_torch/native``) against the JAX
package's, on the CPU.

The port compiles its own copy of ``recordio.cc`` and ``kvstore.cc`` into
its own library (never the JAX package's). Files pass between the two
packages both ways: RecordIO written by one is read by the other, on the
native and the pure-Python paths, and key-value logs reopen in the other
engine with the same contents. The cases of ``tests/test_native.py`` run
on the port's bindings.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np
import pytest

from hops_tpu import native as jax_native
from hops_tpu.native import kvstore as jax_kvstore
from hops_tpu.native import recordio as jax_recordio
from hops_tpu_torch import native
from hops_tpu_torch.native import kvstore, recordio


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built from the port's sources (tests/conftest.py
    builds only the JAX package's)."""
    native.build()
    assert native.available()
    if not jax_native.lib_path().exists():
        import subprocess

        subprocess.run(["make", "-C", str(jax_native.lib_path().parent)], check=True,
                       capture_output=True)


def _python_only(monkeypatch, module):
    monkeypatch.setattr(module, "_lib", lambda: None)


def test_port_library_is_built_from_the_port_sources():
    lib = Path(native.load()._name).resolve()
    src_dir = Path(native.__file__).parent.resolve()
    assert lib == native.lib_path().resolve() == src_dir / "_build" / "libhops_native.so"
    assert lib != jax_native.lib_path().resolve()
    for src in ("recordio.cc", "kvstore.cc"):
        assert (src_dir / src).read_bytes() == (jax_native.lib_path().parent / src).read_bytes()


def test_build_is_a_no_op_when_fresh_and_rebuilds_when_stale():
    lib = native.lib_path()
    before = lib.stat().st_mtime_ns
    assert native.build() == lib and lib.stat().st_mtime_ns == before
    src = Path(native.__file__).parent / "recordio.cc"
    os.utime(lib, ns=(before, src.stat().st_mtime_ns - 10**9))  # older than a source
    native.build()
    assert lib.stat().st_mtime_ns > src.stat().st_mtime_ns
    assert not list(lib.parent.glob(".libhops_native.so.*"))


# -- RecordIO across the two packages ------------------------------------------


def _payloads(n=120):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.mark.parametrize("writer_python", [False, True], ids=["native-writer", "python-writer"])
@pytest.mark.parametrize("reader_python", [False, True], ids=["native-reader", "python-reader"])
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_recordio_files_pass_between_packages(tmp_path, monkeypatch, direction,
                                              writer_python, reader_python):
    w_mod, r_mod = ((recordio, jax_recordio) if direction == "port-to-jax"
                    else (jax_recordio, recordio))
    path = tmp_path / "x.rio"
    payloads = _payloads()
    if writer_python:
        _python_only(monkeypatch, w_mod)
    with w_mod.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    monkeypatch.undo()
    if reader_python:
        _python_only(monkeypatch, r_mod)
    with r_mod.RecordReader(path) as r:
        assert (r._lib is None) == reader_python
        assert len(r) == len(payloads)
        assert list(r) == payloads
        order = np.random.default_rng(0).permutation(len(payloads))
        assert r.read_batch(order) == [payloads[i] for i in order]


def test_recordio_index_files_are_byte_identical(tmp_path):
    payloads = _payloads(40)
    for mod, name in ((recordio, "port"), (jax_recordio, "jax")):
        with mod.RecordWriter(tmp_path / f"{name}.rio") as w:
            for p in payloads:
                w.write(p)
    for suffix in ("", ".idx"):
        assert ((tmp_path / f"port.rio{suffix}").read_bytes()
                == (tmp_path / f"jax.rio{suffix}").read_bytes())


@pytest.mark.parametrize("force_python", [False, True])
def test_recordio_roundtrip(tmp_path, monkeypatch, force_python):
    if force_python:
        _python_only(monkeypatch, recordio)
    path = tmp_path / "r.rio"
    with recordio.RecordWriter(path) as w:
        for i in range(1000):
            w.write(f"record-{i}".encode())
    with recordio.RecordReader(path) as r:
        assert len(r) == 1000
        assert r.read(0) == b"record-0"
        assert r.read(999) == b"record-999"
        assert r.read(500) == b"record-500"


def test_recordio_index_rebuild(tmp_path):
    path = tmp_path / "noidx.rio"
    with recordio.RecordWriter(path) as w:
        for i in range(10):
            w.write(f"{i}".encode())
    (tmp_path / "noidx.rio.idx").unlink()
    for force_python in (False, True):
        mp = pytest.MonkeyPatch()
        if force_python:
            _python_only(mp, recordio)
        with recordio.RecordReader(path) as r:
            assert len(r) == 10 and r.read(7) == b"7"
        mp.undo()


def test_batch_read_matches_single_reads(tmp_path):
    path = str(tmp_path / "batch.rio")
    payloads = [bytes([i % 251]) * (i * 7 % 300) for i in range(200)]
    with recordio.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    with recordio.RecordReader(path) as r:
        assert r._lib is not None
        order = np.random.RandomState(0).permutation(200)
        got = r.read_batch(order, n_threads=4)
        assert got == [r.read(int(i)) for i in order] == [payloads[i] for i in order]
        assert r.read_batch([]) == []
        assert r.read_batch([5], n_threads=1) == [payloads[5]]
        with pytest.raises(IndexError):
            r.read_batch([0, 10**6])


def test_pure_python_fallback_equals_native_backend(tmp_path, monkeypatch):
    path = str(tmp_path / "fb.rio")
    payloads = _payloads(64)
    with recordio.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    order = np.random.default_rng(1).permutation(64)
    with recordio.RecordReader(path) as r:
        assert r._lib is not None
        fast = (list(r), r.read_batch(order))
    monkeypatch.setenv("HOPS_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(recordio, "_bound", None)
    with recordio.RecordReader(path) as r:
        assert r._lib is None
        assert (list(r), r.read_batch(order)) == fast


def test_stale_library_degrades_to_python(tmp_path, monkeypatch):
    def stale_bind(lib):
        raise AttributeError("function rio_read_batch not found")

    monkeypatch.setattr(recordio, "_bound", None)
    monkeypatch.setattr(recordio, "_bind_failed", False)
    monkeypatch.setattr(recordio, "_bind", stale_bind)
    path = str(tmp_path / "stale.rio")
    with recordio.RecordWriter(path) as w:
        w.write(b"still works")
    with recordio.RecordReader(path) as r:
        assert r._lib is None
        assert r.read_batch([0]) == [b"still works"]


def test_failed_build_falls_back_once(tmp_path, monkeypatch):
    """A compiler that fails leaves the bindings on their pure-Python path
    (logged), and is not retried on every call."""
    calls = []

    def broken_build():
        calls.append(1)
        raise OSError("g++: not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build", broken_build)
    monkeypatch.setattr(recordio, "_bound", None)
    assert native.load() is None and native.load() is None
    assert len(calls) == 1
    with recordio.RecordWriter(tmp_path / "p.rio") as w:
        w.write(b"python")
    with recordio.RecordReader(tmp_path / "p.rio") as r:
        assert r._lib is None and r.read(0) == b"python"


# -- the key-value engine --------------------------------------------------------


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_kvstore_files_pass_between_packages(tmp_path, direction):
    a, b = (kvstore, jax_kvstore) if direction == "port-to-jax" else (jax_kvstore, kvstore)
    path = str(tmp_path / "s.hkv")
    kv = a.NativeKV(path)
    for i in range(60):
        kv.put(f"k{i}", f"v{i}" * (i % 5 + 1))
    kv.put("uni", "héllo ✓")
    for i in range(0, 60, 4):
        kv.delete(f"k{i}")
    kv.flush()
    want = {k: kv.get(k) for k in [f"k{i}" for i in range(60)] + ["uni", "absent"]}
    kv.close()
    other = b.NativeKV(path)
    assert {k: other.get(k) for k in want} == want
    assert other.count() == a_count(want)
    other.put("after", "reopen")
    other.close()
    again = a.NativeKV(path)
    assert again.get("after") == "reopen" and again.get("uni") == "héllo ✓"
    again.close()


def a_count(values: dict) -> int:
    return sum(v is not None for v in values.values())


def test_kvstore_crud_and_persistence(tmp_path):
    path = str(tmp_path / "s.hkv")
    kv = kvstore.NativeKV(path)
    kv.put("k1", "v1")
    kv.put("k2", "v2")
    kv.put("k1", "v1b")
    kv.delete("k2")
    assert kv.get("k1") == "v1b" and kv.get("k2") is None and kv.count() == 1
    kv.flush()
    kv.close()
    kv2 = kvstore.NativeKV(path)
    assert kv2.get("k1") == "v1b" and kv2.count() == 1
    kv2.close()


def test_kvstore_scan_and_compact(tmp_path):
    kv = kvstore.NativeKV(str(tmp_path / "c.hkv"))
    for i in range(50):
        kv.put(f"k{i}", f"v{i}")
    for i in range(25):
        kv.delete(f"k{i}")
    assert kv.count() == 25
    assert sorted(kv.scan()) == sorted(f"v{i}" for i in range(25, 50))
    assert kv.compact() > 0
    assert kv.get("k30") == "v30" and kv.count() == 25
    kv.close()


def test_kvstore_get_many_matches_single_gets(tmp_path):
    kv = kvstore.NativeKV(str(tmp_path / "m.hkv"))
    for i in range(100):
        kv.put(f"k{i}", f"v{i}" * (i % 7 + 1))
    kv.delete("k50")
    kv.put("empty", "")
    keys = [f"k{i}" for i in range(0, 120, 3)] + ["k50", "absent", "k1", "empty"]
    assert kv.get_many(keys) == [kv.get(k) for k in keys]
    assert kv.get_many([]) == []
    big = "x" * 1_000_000
    kv.put("big", big)
    assert kv.get("big") == big
    kv.close()


def test_kvstore_torn_tail_truncated(tmp_path):
    """A crash mid-value-write neither poisons the index on reopen nor
    leaves bytes a third open parses as phantom records."""
    path = str(tmp_path / "torn.hkv")
    kv = kvstore.NativeKV(path)
    kv.put("good", "v1")
    kv.flush()
    kv.close()
    with open(path, "ab") as f:
        key = b"torn"
        val = struct.pack("<II", 2, 2) + b"zzZZzzZZ" * 8
        f.write(struct.pack("<II", len(key), len(val) + 100))
        f.write(key)
        f.write(val)
    kv2 = kvstore.NativeKV(path)
    assert kv2.count() == 1 and kv2.get("torn") is None
    kv2.put("x", "y")
    kv2.close()
    kv3 = kvstore.NativeKV(path)
    assert sorted(kv3.scan()) == ["v1", "y"] and kv3.count() == 2
    kv3.close()


def test_kvstore_without_library_raises(monkeypatch):
    monkeypatch.setattr(kvstore, "_bound", None)
    monkeypatch.setenv("HOPS_TPU_DISABLE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        kvstore.NativeKV("unused.hkv")
