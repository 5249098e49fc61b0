"""The port's packed wire codec (``hops_tpu_torch.runtime.wirecodec``, a
copy) against the JAX package's: frames are byte-identical for seeded
columns of every wire dtype, each package decodes the other's frames,
and a truncated frame fails with the same offset in its message.
"""

from __future__ import annotations

import numpy as np
import pytest

from hops_tpu.runtime import wirecodec as ref
from hops_tpu_torch.runtime import wirecodec as port

DTYPES = sorted(ref._WIRE_DTYPES)


def _column(dtype: str, seed: int, shape=(5, 3)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.integers(0, 2, shape).astype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
    return rng.standard_normal(shape).astype(dt)


def test_same_wire_dtypes_and_media_type():
    assert port._WIRE_DTYPES == ref._WIRE_DTYPES
    assert (port.MEDIA_TYPE, port.MAGIC, port.VERSION) == (ref.MEDIA_TYPE, ref.MAGIC, ref.VERSION)


@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_byte_identical_and_cross_decode(dtype):
    cols = [("a", _column(dtype, 1)), ("b", _column(dtype, 2, (4,))),
            ("raw", b"\x00\x01opaque"), ("scalar", _column(dtype, 3, ()))]
    frame = port.encode_frame(cols)
    assert frame == ref.encode_frame(cols)
    for decode in (port.decode_frame, ref.decode_frame):
        out = decode(frame)
        for name, col in cols:
            if isinstance(col, bytes):
                assert bytes(out[name]) == col
            else:
                np.testing.assert_array_equal(out[name], col)
                assert out[name].dtype == col.dtype

    inst = _column(dtype, 4, (6, 2, 2))
    frame = port.encode_instances(inst)
    assert frame == ref.encode_instances(inst)
    np.testing.assert_array_equal(ref.decode_instances(frame), inst)
    np.testing.assert_array_equal(port.decode_instances(ref.encode_instances(inst)), inst)


@pytest.mark.parametrize("preds", [
    [[0.5, -1.25], [3.0, 4.0]],
    [[1, 2, 3], [4, 5, 6]],
    [[True, False]],
    [[1, 2], [3]],           # ragged: both fall back to JSON
    [{"label": 1}],          # objects: both fall back to JSON
])
def test_try_encode_predictions_matches(preds):
    got, want = port.try_encode_predictions(preds), ref.try_encode_predictions(preds)
    assert got == want
    if want is not None:
        np.testing.assert_array_equal(port.decode_predictions(want), ref.decode_predictions(got))


@pytest.mark.parametrize("cut", [3, 8, 12, 20, -1])
def test_truncated_frame_raises_same_offset(cut):
    frame = ref.encode_instances(_column("<f4", 5, (4, 3)))
    bad = frame[:cut]
    with pytest.raises(ref.WireCodecError) as want:
        ref.decode_instances(bad)
    with pytest.raises(port.WireCodecError) as got:
        port.decode_instances(bad)
    assert str(got.value) == str(want.value)
    assert "offset" in str(got.value)
