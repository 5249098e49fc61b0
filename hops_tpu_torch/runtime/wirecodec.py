"""Packed columnar wire codec for tensor-shaped payloads
(a copy of ``hops_tpu/runtime/wirecodec.py``: the module imports no JAX, and
the port imports nothing of the JAX package).

With the event-loop transport the per-hop HTTP overhead is gone, which
leaves Python-side JSON as the dominant per-request cost on the serving
and feature data planes: replicas ``json.loads`` instance bodies, remote
feature shards ship ``multi_get`` rows as JSON, and the online store
decodes row JSON per batch. This module is the TF-Serving-style answer —
a versioned, typed, columnar binary frame that decodes zero-copy via
``np.frombuffer`` and encodes straight from C-contiguous arrays with no
Python-level float loop. Semantics stay exact: the packed and JSON paths
are pinned bit-identical by tests.

Frame layout (all integers little-endian, ``struct`` ``<``)::

    offset 0   magic      4 bytes   b"\\x89HWC"
    offset 4   version    u8        1
    offset 5   bom        u16       0x0102 (wire bytes \\x02\\x01); a
                                    reader that sees 0x0201 is looking at
                                    a byte-swapped frame and must reject
    offset 7   ncols      u16
    then per column, ncols times:
        name_len   u16
        name       utf-8 bytes
        kind       u8        0 = ndarray column, 1 = opaque bytes column
        kind 0:    dtype_len u8, dtype ascii (numpy str, e.g. "<f4"),
                   ndim u8, ndim x u32 dims, nbytes u64
        kind 1:    nbytes u64
    then all column buffers, contiguous, in column order.

The total frame length is validated exactly — both truncation and
trailing garbage fail closed with :class:`WireCodecError` naming the
byte offset. Array columns additionally validate
``nbytes == prod(dims) * itemsize``.

Content negotiation uses :data:`MEDIA_TYPE`
(``application/x-hops-packed``). JSON stays the default everywhere; the
packed path is opt-in per request (``Content-Type`` on the way in,
``Accept`` on the way out) and per shard (advertised in the shardd
healthz handshake).

On top of the frame, three payload shapes:

- predict requests/responses — a single tensor column
  (:func:`encode_instances` / :func:`decode_instances` /
  :func:`try_encode_predictions` / :func:`decode_predictions`);
- feature row batches — one numpy column per feature plus a reserved
  presence column, with a JSON-bytes fallback column for
  non-columnar batches (:func:`encode_rows` / :func:`decode_rows`);
- single kvstore rows — a compact struct-packed record behind the
  ``"\\x01"`` format byte (:func:`pack_row` / :func:`unpack_row`),
  latin-1-decoded so it rides the existing str-valued backends and
  coexists with legacy JSON rows in the same ``.hkv``/``.db`` file.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Any, Sequence

import numpy as np

from hops_tpu_torch.telemetry.metrics import REGISTRY

__all__ = [
    "MEDIA_TYPE",
    "MAGIC",
    "VERSION",
    "ROW_FORMAT_PACKED",
    "WireCodecError",
    "is_packed",
    "is_packed_row",
    "encode_frame",
    "decode_frame",
    "frame_summary",
    "encode_instances",
    "decode_instances",
    "try_encode_predictions",
    "decode_predictions",
    "encode_rows",
    "decode_rows",
    "pack_row",
    "unpack_row",
    "count_request",
]

#: Media type used for Content-Type / Accept negotiation.
MEDIA_TYPE = "application/x-hops-packed"

MAGIC = b"\x89HWC"
VERSION = 1

#: Byte-order mark: written as the little-endian u16 0x0102 (wire bytes
#: ``\x02\x01``). A reader that decodes 0x0201 is on the wrong end of a
#: byte-swapped frame.
_BOM = 0x0102
_BOM_SWAPPED = 0x0201

_HDR = struct.Struct("<4sBHH")  # magic, version, bom, ncols

_KIND_ARRAY = 0
_KIND_BYTES = 1

#: Column names starting with NUL are reserved for codec-internal
#: columns; user data never collides because real feature/column names
#: are printable.
_COL_PRESENT = "\x00present"
_COL_ROWS_JSON = "\x00rows"

#: Format byte prefix for packed single-row kvstore values. Legacy rows
#: are JSON objects and always start with ``{``, so a one-character
#: sniff disambiguates.
ROW_FORMAT_PACKED = "\x01"

#: numpy dtype strings allowed on the wire — little-endian or
#: byte-order-free numeric/bool types only. bf16 travels as ``<u2``
#: (the caller views/reinterprets); object/str columns are rejected.
_WIRE_DTYPES = frozenset({
    "<f8", "<f4", "<f2",
    "<i8", "<i4", "<i2", "|i1",
    "<u8", "<u4", "<u2", "|u1",
    "|b1",
})

# Children bound once at import — observe() on the hot path skips the
# per-call label lookup.
_ENCODE_SECONDS = REGISTRY.histogram(
    "hops_tpu_wire_encode_seconds",
    "Wall time spent encoding packed wire frames.",
).labels()
_DECODE_SECONDS = REGISTRY.histogram(
    "hops_tpu_wire_decode_seconds",
    "Wall time spent decoding packed wire frames.",
).labels()
_REQUESTS_TOTAL = REGISTRY.counter(
    "hops_tpu_wire_requests_total",
    "Predict requests by wire format.",
    labels=("format",),
)


class WireCodecError(ValueError):
    """A frame failed encode/decode validation.

    Decode-side messages name the byte offset where validation failed so
    truncation and corruption are diagnosable from the error alone.
    """


def count_request(fmt: str) -> None:
    """Count one predict request decoded in wire format ``fmt``."""
    _REQUESTS_TOTAL.labels(format=fmt).inc()


def is_packed(data: bytes | bytearray | memoryview | None) -> bool:
    """Cheap sniff: does ``data`` start with the packed-frame magic?"""
    return data is not None and bytes(data[:4]) == MAGIC


def is_packed_row(raw: str | None) -> bool:
    """Does a stored kvstore row value use the packed single-row format?"""
    return bool(raw) and raw[0] == ROW_FORMAT_PACKED


# ---------------------------------------------------------------------------
# frame encode / decode


def encode_frame(columns: Sequence[tuple[str, Any]]) -> bytes:
    """Encode named columns into one packed frame.

    Each column value is either an ndarray-convertible (becomes a kind-0
    tensor column; must land on a wire dtype) or ``bytes``/``bytearray``
    /``memoryview`` (kind-1 opaque bytes column). Big-endian arrays are
    byte-swapped to little-endian; non-contiguous arrays are made
    contiguous. Raises :class:`WireCodecError` for un-encodable dtypes
    (object/str — i.e. ragged or mixed columns).
    """
    t0 = time.perf_counter()
    if len(columns) > 0xFFFF:
        raise WireCodecError(f"too many columns: {len(columns)} > 65535")
    head: list[bytes] = [_HDR.pack(MAGIC, VERSION, _BOM, len(columns))]
    bufs: list[bytes] = []
    for name, col in columns:
        nb = name.encode("utf-8")
        if len(nb) > 0xFFFF:
            raise WireCodecError(f"column name too long: {len(nb)} bytes")
        head.append(struct.pack("<H", len(nb)))
        head.append(nb)
        if isinstance(col, (bytes, bytearray, memoryview)):
            raw = bytes(col)
            head.append(struct.pack("<BQ", _KIND_BYTES, len(raw)))
            bufs.append(raw)
            continue
        arr = col if isinstance(col, np.ndarray) else np.asarray(col)
        if not arr.flags.c_contiguous:
            # ascontiguousarray would promote 0-d to 1-d, but 0-d is
            # always contiguous so it never reaches this branch.
            arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        dt = arr.dtype.str.encode("ascii")
        if arr.dtype.str not in _WIRE_DTYPES:
            raise WireCodecError(
                f"column {name!r} has dtype {arr.dtype.str!r} which is not "
                f"wire-encodable (ragged/object/str columns cannot be packed)")
        if arr.ndim > 0xFF:
            raise WireCodecError(f"column {name!r} has ndim {arr.ndim} > 255")
        head.append(struct.pack("<BB", _KIND_ARRAY, len(dt)))
        head.append(dt)
        head.append(struct.pack("<B", arr.ndim))
        if arr.ndim:
            for dim in arr.shape:
                if dim > 0xFFFFFFFF:
                    raise WireCodecError(
                        f"column {name!r} dim {dim} exceeds u32")
            head.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        head.append(struct.pack("<Q", arr.nbytes))
        bufs.append(arr.tobytes())
    out = b"".join(head) + b"".join(bufs)
    _ENCODE_SECONDS.observe(time.perf_counter() - t0)
    return out


def _need(data: bytes, off: int, n: int, what: str) -> None:
    if off + n > len(data):
        raise WireCodecError(
            f"frame truncated at offset {off}: need {n} byte(s) for {what}, "
            f"have {len(data) - off}")


def _decode_headers(
    data: bytes,
) -> tuple[list[tuple[str, int, str, tuple[int, ...], int]], int]:
    """Parse frame headers only. Returns
    ``([(name, kind, dtype, dims, nbytes)], buffers_start_offset)``.

    Validates magic/version/BOM and per-column header integrity, plus
    the exact total frame length (buffers must be fully present with no
    trailing bytes).
    """
    _need(data, 0, _HDR.size, "frame header")
    magic, version, bom, ncols = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise WireCodecError(
            f"bad magic at offset 0: {magic!r} (not a packed frame)")
    if version != VERSION:
        raise WireCodecError(
            f"unsupported frame version {version} at offset 4 "
            f"(this reader speaks version {VERSION})")
    if bom == _BOM_SWAPPED:
        raise WireCodecError(
            "byte-order mark at offset 5 reads 0x0201: frame was written "
            "by a big-endian encoder; this reader only accepts "
            "little-endian frames")
    if bom != _BOM:
        raise WireCodecError(
            f"bad byte-order mark 0x{bom:04x} at offset 5 "
            f"(expected 0x{_BOM:04x})")
    off = _HDR.size
    cols: list[tuple[str, int, str, tuple[int, ...], int]] = []
    seen: set[str] = set()
    for i in range(ncols):
        _need(data, off, 2, f"column {i} name length")
        (name_len,) = struct.unpack_from("<H", data, off)
        off += 2
        _need(data, off, name_len, f"column {i} name")
        try:
            name = data[off:off + name_len].decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireCodecError(
                f"column {i} name at offset {off} is not valid utf-8: "
                f"{exc}") from None
        off += name_len
        if name in seen:
            raise WireCodecError(
                f"duplicate column name {name!r} at offset {off}")
        seen.add(name)
        _need(data, off, 1, f"column {name!r} kind")
        kind = data[off]
        off += 1
        if kind == _KIND_BYTES:
            _need(data, off, 8, f"column {name!r} byte length")
            (nbytes,) = struct.unpack_from("<Q", data, off)
            off += 8
            cols.append((name, kind, "", (), nbytes))
            continue
        if kind != _KIND_ARRAY:
            raise WireCodecError(
                f"column {name!r} has unknown kind {kind} at offset "
                f"{off - 1}")
        _need(data, off, 1, f"column {name!r} dtype length")
        dt_len = data[off]
        off += 1
        _need(data, off, dt_len, f"column {name!r} dtype")
        dtype = data[off:off + dt_len].decode("ascii", "replace")
        if dtype not in _WIRE_DTYPES:
            raise WireCodecError(
                f"column {name!r} dtype {dtype!r} at offset {off} is not "
                f"an accepted little-endian wire dtype")
        off += dt_len
        _need(data, off, 1, f"column {name!r} ndim")
        ndim = data[off]
        off += 1
        _need(data, off, 4 * ndim, f"column {name!r} dims")
        dims = struct.unpack_from(f"<{ndim}I", data, off) if ndim else ()
        off += 4 * ndim
        _need(data, off, 8, f"column {name!r} byte length")
        (nbytes,) = struct.unpack_from("<Q", data, off)
        off += 8
        count = 1
        for dim in dims:
            count *= dim
        expect = count * np.dtype(dtype).itemsize
        if nbytes != expect:
            raise WireCodecError(
                f"column {name!r} header at offset {off - 8} declares "
                f"{nbytes} bytes but shape {tuple(dims)} x dtype {dtype} "
                f"needs {expect}")
        cols.append((name, kind, dtype, tuple(dims), nbytes))
    total = off + sum(c[4] for c in cols)
    if len(data) < total:
        raise WireCodecError(
            f"frame truncated at offset {len(data)}: headers promise "
            f"{total} total bytes")
    if len(data) > total:
        raise WireCodecError(
            f"{len(data) - total} trailing byte(s) after offset {total}")
    return cols, off


def decode_frame(data: bytes | bytearray | memoryview) -> dict[str, Any]:
    """Decode a packed frame into ``{name: ndarray | bytes}``.

    Array columns are zero-copy views over ``data`` (via
    ``np.frombuffer``) and therefore read-only; callers that mutate must
    copy. Column order is preserved. Raises :class:`WireCodecError` on
    any malformation, naming the byte offset.
    """
    t0 = time.perf_counter()
    data = bytes(data) if not isinstance(data, bytes) else data
    cols, off = _decode_headers(data)
    out: dict[str, Any] = {}
    for name, kind, dtype, dims, nbytes in cols:
        if kind == _KIND_BYTES:
            out[name] = data[off:off + nbytes]
        else:
            dt = np.dtype(dtype)
            arr = np.frombuffer(data, dtype=dt,
                                count=nbytes // dt.itemsize, offset=off)
            out[name] = arr.reshape(dims)
        off += nbytes
    _DECODE_SECONDS.observe(time.perf_counter() - t0)
    return out


def frame_summary(data: bytes | bytearray | memoryview) -> dict[str, Any]:
    """Header-only summary of a packed frame — no buffer decode.

    Shape mirrors the workload-capture payload summary so armed capture
    on packed-body fleets records shapes instead of decode warnings::

        {"bytes": N, "format": "packed",
         "columns": [{"name", "dtype", "shape"} | {"name", "bytes"}]}
    """
    data = bytes(data) if not isinstance(data, bytes) else data
    cols, _ = _decode_headers(data)
    summary: dict[str, Any] = {
        "bytes": len(data), "format": "packed", "columns": []}
    for name, kind, dtype, dims, nbytes in cols:
        if kind == _KIND_BYTES:
            summary["columns"].append({"name": name, "bytes": nbytes})
        else:
            summary["columns"].append(
                {"name": name, "dtype": dtype, "shape": list(dims)})
    return summary


# ---------------------------------------------------------------------------
# predict bodies: a single tensor column


def encode_instances(instances: Any) -> bytes:
    """Encode a predict-request instance batch as one tensor column."""
    arr = instances if isinstance(instances, np.ndarray) else None
    if arr is None:
        try:
            arr = np.asarray(instances)
        except (ValueError, TypeError) as exc:
            raise WireCodecError(
                f"instances are not a rectangular tensor: {exc}") from None
    if arr.dtype == object:
        raise WireCodecError(
            "instances are ragged or non-numeric and cannot be packed")
    return encode_frame([("instances", arr)])


def decode_instances(data: bytes | bytearray | memoryview) -> np.ndarray:
    """Decode a packed predict request; returns the instance tensor."""
    cols = decode_frame(data)
    arr = cols.get("instances")
    if not isinstance(arr, np.ndarray):
        raise WireCodecError(
            "packed predict request must carry an 'instances' tensor column")
    return arr


def try_encode_predictions(preds: Any) -> bytes | None:
    """Encode a predictions payload, or ``None`` if it cannot be packed.

    ``None`` (ragged rows, object dtypes, non-tensor payloads) tells the
    caller to fall back to JSON — exactness over format. Natural dtype is
    preserved: ``.tolist()`` outputs become f64 columns so the packed
    response is bit-identical to what JSON would have carried.
    """
    try:
        arr = preds if isinstance(preds, np.ndarray) else np.asarray(preds)
    except (ValueError, TypeError):
        return None
    if arr.dtype == object:
        return None
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    if arr.dtype.str not in _WIRE_DTYPES:
        return None
    return encode_frame([("predictions", arr)])


def decode_predictions(data: bytes | bytearray | memoryview) -> np.ndarray:
    """Decode a packed predict response; returns the prediction tensor."""
    cols = decode_frame(data)
    arr = cols.get("predictions")
    if not isinstance(arr, np.ndarray):
        raise WireCodecError(
            "packed predict response must carry a 'predictions' tensor "
            "column")
    return arr


# ---------------------------------------------------------------------------
# feature row batches: columnar dict-of-rows


def _column_array(vals: list[Any]) -> np.ndarray | None:
    """Type a row-batch column, or ``None`` if it is not numeric-uniform.

    Plain-Python/NumPy scalars only — bool before int (bool is an int
    subclass), and exact float64/int64 so the decode round-trips the
    original values bit-for-bit.
    """
    if all(isinstance(v, (bool, np.bool_)) for v in vals):
        return np.asarray(vals, dtype=np.bool_)
    if all(isinstance(v, (int, np.integer))
           and not isinstance(v, (bool, np.bool_)) for v in vals):
        try:
            return np.asarray([int(v) for v in vals], dtype=np.int64)
        except OverflowError:
            return None
    if all(isinstance(v, (float, np.floating)) for v in vals):
        return np.asarray([float(v) for v in vals], dtype=np.float64)
    return None


def encode_rows(rows: Sequence[dict | None]) -> bytes:
    """Encode a ``multi_get``-style row batch columnar.

    ``None`` entries (missing keys) travel in a reserved presence
    column. Homogeneous batches get one column per feature — numeric
    columns as typed arrays, everything else as a JSON-bytes column.
    Batches whose rows disagree on key sets fall back to a single
    JSON-bytes column; either way :func:`decode_rows` returns exactly
    what ``json.loads`` of the JSON encoding would have.
    """
    present = [r for r in rows if r is not None]
    mask = np.fromiter((r is not None for r in rows), dtype=np.bool_,
                       count=len(rows))
    names = list(present[0].keys()) if present else []
    homogeneous = (
        present
        and not any(n.startswith("\x00") for n in names)
        and all(set(r.keys()) == set(names) for r in present[1:])
    )
    cols: list[tuple[str, Any]] = [(_COL_PRESENT, mask)]
    if not present:
        return encode_frame(cols)
    if not homogeneous:
        blob = json.dumps(list(rows), default=str,
                          separators=(",", ":")).encode("utf-8")
        cols.append((_COL_ROWS_JSON, blob))
        return encode_frame(cols)
    for name in names:
        vals = [r[name] for r in present]
        arr = _column_array(vals)
        if arr is not None:
            cols.append((name, arr))
        else:
            blob = json.dumps(vals, default=str,
                              separators=(",", ":")).encode("utf-8")
            cols.append((name, blob))
    return encode_frame(cols)


def decode_rows(data: bytes | bytearray | memoryview) -> list[dict | None]:
    """Decode a packed row batch back into ``list[dict | None]``."""
    cols = decode_frame(data)
    if _COL_PRESENT not in cols:
        raise WireCodecError(
            "packed row batch is missing its presence column")
    mask = cols.pop(_COL_PRESENT)
    if not isinstance(mask, np.ndarray) or mask.dtype != np.bool_ \
            or mask.ndim != 1:
        raise WireCodecError(
            "packed row batch presence column must be a 1-d bool array")
    if _COL_ROWS_JSON in cols:
        rows = json.loads(bytes(cols[_COL_ROWS_JSON]))
        if len(rows) != len(mask):
            raise WireCodecError(
                f"packed row batch fallback carries {len(rows)} rows but "
                f"presence declares {len(mask)}")
        return rows
    n_present = int(mask.sum())
    names: list[str] = []
    series: list[list[Any]] = []
    for name, col in cols.items():
        vals = col.tolist() if isinstance(col, np.ndarray) \
            else json.loads(bytes(col))
        if len(vals) != n_present:
            raise WireCodecError(
                f"packed row batch column {name!r} carries {len(vals)} "
                f"values but presence declares {n_present}")
        names.append(name)
        series.append(vals)
    if series:
        built = iter([dict(zip(names, t)) for t in zip(*series)])
    else:
        built = iter([{} for _ in range(n_present)])
    return [next(built) if p else None for p in mask.tolist()]


# ---------------------------------------------------------------------------
# single kvstore rows: compact struct records behind a format byte


def pack_row(rec: dict) -> str:
    """Pack one feature row into the kvstore's str value space.

    Layout after the ``"\\x01"`` format byte (latin-1-decoded binary so
    it survives the str-valued backends and the utf-8 round trip to
    disk): u16 ncols, then per column u16 key_len + key, one typecode
    byte, and a typed payload —

    ``f`` f64 · ``i`` i64 · ``s`` u32 len + utf-8 · ``T``/``F`` bool ·
    ``n`` None · ``j`` u32 len + JSON (lists, timestamps, big ints; the
    same ``default=str`` coercion the legacy JSON rows used).
    """
    parts = [struct.pack("<H", len(rec))]
    for k, v in rec.items():
        kb = str(k).encode("utf-8")
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        if v is None:
            parts.append(b"n")
        elif isinstance(v, (bool, np.bool_)):
            parts.append(b"T" if v else b"F")
        elif isinstance(v, (int, np.integer)) \
                and -(1 << 63) <= int(v) < (1 << 63):
            parts.append(b"i" + struct.pack("<q", int(v)))
        elif isinstance(v, (float, np.floating)):
            parts.append(b"f" + struct.pack("<d", float(v)))
        elif isinstance(v, str):
            sb = v.encode("utf-8")
            parts.append(b"s" + struct.pack("<I", len(sb)) + sb)
        else:
            jb = json.dumps(v, default=str,
                            separators=(",", ":")).encode("utf-8")
            parts.append(b"j" + struct.pack("<I", len(jb)) + jb)
    return ROW_FORMAT_PACKED + b"".join(parts).decode("latin-1")


def unpack_row(raw: str) -> dict:
    """Decode a :func:`pack_row` value back into the original dict."""
    if not is_packed_row(raw):
        raise WireCodecError("value does not carry the packed-row format "
                             "byte")
    data = raw[1:].encode("latin-1")
    _need(data, 0, 2, "row column count")
    (ncols,) = struct.unpack_from("<H", data, 0)
    off = 2
    rec: dict[str, Any] = {}
    for i in range(ncols):
        _need(data, off, 2, f"row column {i} key length")
        (klen,) = struct.unpack_from("<H", data, off)
        off += 2
        _need(data, off, klen, f"row column {i} key")
        key = data[off:off + klen].decode("utf-8")
        off += klen
        _need(data, off, 1, f"row column {key!r} typecode")
        code = data[off:off + 1]
        off += 1
        if code == b"n":
            rec[key] = None
        elif code == b"T":
            rec[key] = True
        elif code == b"F":
            rec[key] = False
        elif code == b"i":
            _need(data, off, 8, f"row column {key!r} i64")
            (rec[key],) = struct.unpack_from("<q", data, off)
            off += 8
        elif code == b"f":
            _need(data, off, 8, f"row column {key!r} f64")
            (rec[key],) = struct.unpack_from("<d", data, off)
            off += 8
        elif code in (b"s", b"j"):
            _need(data, off, 4, f"row column {key!r} length")
            (vlen,) = struct.unpack_from("<I", data, off)
            off += 4
            _need(data, off, vlen, f"row column {key!r} value")
            chunk = data[off:off + vlen]
            off += vlen
            rec[key] = (chunk.decode("utf-8") if code == b"s"
                        else json.loads(chunk))
        else:
            raise WireCodecError(
                f"row column {key!r} has unknown typecode {code!r} at "
                f"offset {off - 1}")
    if off != len(data):
        raise WireCodecError(
            f"{len(data) - off} trailing byte(s) after offset {off} in "
            f"packed row")
    return rec
