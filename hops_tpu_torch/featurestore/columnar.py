"""Schema'd columnar training-data format (the Petastorm role) (counterpart of
``hops_tpu/featurestore/columnar.py``, copied with the port's imports).

The reference materializes training datasets through Petastorm
(notebooks/featurestore/petastorm/PetastormHelloWorld.ipynb:21-44,
``materialize_dataset`` cell 10): parquet plus a *unischema* so tensor
columns (images, sequences) round-trip with dtype and shape, and readers
can project columns and stream shuffled row groups. This is that
capability, for the card's feeder:

- **schema.json** records every field's dtype, and for tensor fields the
  per-row shape — so the feeder reconstructs device-ready ndarrays
  without Python-object sniffing;
- tensor cells are stored as raw little-endian bytes in parquet binary
  columns (one row = one tensor), scalars as native parquet columns;
- **row groups** are the shuffle/streaming granule: :class:`RowGroupReader`
  yields column-projected, decoded numpy batches one row group at a
  time in (optionally) shuffled order — a windowed shuffle that never
  materializes the dataset, which is what keeps a feed HBM-friendly.

No Spark, no codegen: parquet row groups via pyarrow, numpy decode.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import pandas as pd

_SCHEMA_FILE = "schema.json"


def _infer_schema(df: pd.DataFrame) -> dict[str, dict[str, Any]]:
    schema: dict[str, dict[str, Any]] = {}
    for c in df.columns:
        first = df[c].iloc[0] if len(df) else None
        if isinstance(first, np.ndarray):
            arr = np.asarray(first)
            schema[str(c)] = {
                "kind": "tensor",
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }
        else:
            schema[str(c)] = {"kind": "scalar", "dtype": str(df[c].dtype)}
    return schema


def write_dataset(
    d: Path | str,
    df: pd.DataFrame,
    *,
    row_group_size: int = 1024,
    part: int = 0,
) -> None:
    """Materialize ``df`` under ``d`` as ``part-{part:05d}.parquet`` with
    ``row_group_size``-row groups plus (for part 0) the unischema."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    schema = _infer_schema(df)
    cols: dict[str, Any] = {}
    for c, spec in schema.items():
        if spec["kind"] == "tensor":
            want = np.dtype(spec["dtype"])
            shape = tuple(spec["shape"])
            cells = []
            for x in df[c]:
                arr = np.ascontiguousarray(np.asarray(x, dtype=want))
                if arr.shape != shape:
                    raise ValueError(
                        f"tensor column {c!r}: row shape {arr.shape} != "
                        f"schema shape {shape}"
                    )
                cells.append(arr.tobytes())
            cols[c] = pd.Series(cells, dtype=object)
        else:
            cols[c] = df[c].reset_index(drop=True)
    flat = pd.DataFrame(cols)
    flat.to_parquet(
        d / f"part-{part:05d}.parquet", index=False, row_group_size=row_group_size
    )
    schema_path = d / _SCHEMA_FILE
    if part == 0 or not schema_path.exists():
        schema_path.write_text(json.dumps(schema, indent=2))
    elif json.loads(schema_path.read_text()) != schema:
        raise ValueError(f"part {part} schema differs from {schema_path}")


def read_schema(d: Path | str) -> dict[str, dict[str, Any]]:
    return json.loads((Path(d) / _SCHEMA_FILE).read_text())


def _decode(table_df: pd.DataFrame, schema: dict) -> pd.DataFrame:
    out: dict[str, Any] = {}
    for c in table_df.columns:
        spec = schema.get(c, {"kind": "scalar"})
        if spec["kind"] == "tensor":
            dtype, shape = np.dtype(spec["dtype"]), tuple(spec["shape"])
            out[c] = pd.Series(
                [np.frombuffer(b, dtype=dtype).reshape(shape) for b in table_df[c]],
                dtype=object,
            )
        else:
            out[c] = table_df[c]
    return pd.DataFrame(out)


def read_dataset(
    d: Path | str, columns: list[str] | None = None
) -> pd.DataFrame:
    """Full (column-projected) read, tensors reconstructed."""
    d = Path(d)
    schema = read_schema(d)
    frames = [
        _decode(pd.read_parquet(p, columns=columns), schema)
        for p in sorted(d.glob("part-*.parquet"))
    ]
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


class RowGroupReader:
    """Stream decoded numpy column batches one parquet row group at a
    time — the Petastorm ``make_reader`` role.

    ``shuffle=True`` permutes row-group order per epoch (seeded), so
    feeding shuffles at the granule level with O(row_group) memory.
    """

    def __init__(
        self,
        d: Path | str,
        columns: list[str] | None = None,
        shuffle: bool = False,
        seed: int = 0,
    ):
        import pyarrow.parquet as pq

        self._pq = pq
        self.dir = Path(d)
        self.schema = read_schema(self.dir)
        self.columns = list(columns) if columns is not None else None
        self.shuffle = shuffle
        self.seed = seed
        self._groups: list[tuple[Path, int]] = []
        for p in sorted(self.dir.glob("part-*.parquet")):
            for g in range(pq.ParquetFile(p).num_row_groups):
                self._groups.append((p, g))
        self._epoch = 0

    def __len__(self) -> int:
        return len(self._groups)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self._groups))
        if self.shuffle:
            order = np.random.RandomState(self.seed + self._epoch).permutation(order)
        self._epoch += 1
        for i in order:
            path, g = self._groups[i]
            table = self._pq.ParquetFile(path).read_row_group(g, columns=self.columns)
            df = _decode(table.to_pandas(), self.schema)
            batch: dict[str, np.ndarray] = {}
            for c in df.columns:
                spec = self.schema.get(c, {"kind": "scalar"})
                if spec["kind"] == "tensor":
                    batch[c] = np.stack(list(df[c]))
                else:
                    batch[c] = df[c].to_numpy()
            yield batch
