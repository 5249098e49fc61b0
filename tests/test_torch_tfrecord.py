"""The port's TFRecord codec (``hops_tpu_torch/featurestore/training_dataset.py``
``_write_tfrecord`` / ``_read_tfrecord``), which needs no TensorFlow,
against the JAX package's, which writes and reads through TensorFlow:
each reads the other's files to the same values (the two writers order a
record's map entries differently, so the bytes differ), and a
``tfrecord`` training dataset saves and reads back through the port
with TensorFlow unimportable, as on the machine with the card."""

from __future__ import annotations

import sys

import numpy as np
import pandas as pd
import pytest

from hops_tpu.featurestore import training_dataset as j_td
from hops_tpu_torch.featurestore import training_dataset as t_td
from hops_tpu_torch.runtime import config as t_config

FRAME = pd.DataFrame({
    "a": [1, -5, 2**40], "b": [0.5, 1e-3, -2.25], "s": ["x", "yy", ""],
    "v": [np.array([1.0, 2.0]), np.array([3.0, 4.5]), np.array([0.0, 1.0])],
    "t": [True, False, True],
})


def _same(got: pd.DataFrame, want: pd.DataFrame) -> None:
    got = got[sorted(got.columns)]
    want = want[sorted(want.columns)]
    assert got.columns.tolist() == want.columns.tolist()
    for c in got.columns:
        assert [np.asarray(x).tolist() for x in got[c]] == [np.asarray(x).tolist() for x in want[c]], c


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_tfrecord(writer, tmp_path):
    path = str(tmp_path / "part.tfrecord")
    (j_td if writer == "jax" else t_td)._write_tfrecord(FRAME, path)
    _same(t_td._read_tfrecord(path, []), j_td._read_tfrecord(path, []))


def test_a_corrupt_record_is_refused(tmp_path):
    path = tmp_path / "part.tfrecord"
    t_td._write_tfrecord(FRAME, str(path))
    data = bytearray(path.read_bytes())
    data[20] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt TFRecord"):
        t_td._read_tfrecord(str(path), [])


def test_tfrecord_training_dataset_without_tensorflow(tmp_path, monkeypatch):
    import hops_tpu_torch.featurestore as hsfs

    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import tensorflow raises
    monkeypatch.setattr(t_config, "_current", t_config.runtime())
    t_config.configure(workspace=str(tmp_path / "ws"), project="testproj")
    fs = hsfs.connection().get_feature_store()
    df = pd.DataFrame({"team_id": np.arange(20), "score": np.linspace(0, 1, 20),
                       "name": [f"t{i}" for i in range(20)]})
    td = fs.create_training_dataset("teams", version=1, data_format="tfrecord",
                                    splits={"train": 0.8, "test": 0.2})
    td.save(df)
    back = pd.concat([td.read("train"), td.read("test")]).sort_values("team_id")
    assert back.columns.tolist() == ["team_id", "score", "name"]
    # float_list holds float32: the scores come back rounded to it.
    pd.testing.assert_frame_equal(back.reset_index(drop=True), df, check_dtype=False,
                                  rtol=1e-7)
