"""The port's feature store (``hops_tpu_torch.featurestore``,
``hops_tpu_torch.sql``) against the JAX package's: each scenario of
``tests/test_featurestore.py`` runs through both packages, each in its own
workspace on the same clock, and their outputs must be equal — frames by
``assert_frame_equal`` (exact dtypes), statistics, validation reports and
commit histories as equal JSON, serving vectors, feeder batches and raised
errors (type and message) as equal values. Then a feature group (two
commits, an online store) and training datasets (Parquet, CSV, RecordIO)
written by one package are read back by the other, both ways.
"""

from __future__ import annotations

import math
import sqlite3
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import hops_tpu.featurestore as jax_hsfs
import hops_tpu.sql as jax_sql
from hops_tpu.featurestore import bias as jax_bias
from hops_tpu.featurestore import builders as jax_builders
from hops_tpu.featurestore import columnar as jax_columnar
from hops_tpu.featurestore import connectors as jax_connectors
from hops_tpu.featurestore import storage as jax_storage
from hops_tpu.featurestore import validation as jax_validation
from hops_tpu.runtime import config as jax_config
from hops_tpu.runtime import fs as jax_hfs

import hops_tpu_torch.featurestore as hsfs
import hops_tpu_torch.sql as sql
from hops_tpu_torch.featurestore import bias, builders, columnar, connectors, storage, validation
from hops_tpu_torch.runtime import config
from hops_tpu_torch.runtime import fs as hfs

PKGS = {
    "jax": SimpleNamespace(name="hops_tpu", hsfs=jax_hsfs, sql=jax_sql, bias=jax_bias,
                           builders=jax_builders, columnar=jax_columnar,
                           connectors=jax_connectors, storage=jax_storage,
                           validation=jax_validation, hfs=jax_hfs, config=jax_config),
    "torch": SimpleNamespace(name="hops_tpu_torch", hsfs=hsfs, sql=sql, bias=bias,
                             builders=builders, columnar=columnar, connectors=connectors,
                             storage=storage, validation=validation, hfs=hfs, config=config),
}
Rule = {"jax": jax_validation.Rule, "torch": validation.Rule}


class _Clock:
    """``time.time`` for both packages' commit ids and validation
    stamps: one second a reading from a fixed start, so the two runs of
    a scenario see the same commit ids."""

    START = 1_700_000_000.0

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.now = self.START

    def time(self) -> float:
        self.now += 1.0
        return self.now


@pytest.fixture(autouse=True)
def torch_workspace(tmp_path, monkeypatch):
    """The port's config in a workspace of its own (tests/conftest.py
    points the JAX package's at ``tmp_path/workspace``)."""
    torch.set_num_threads(1)
    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")
    return tmp_path / "torch_ws"


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.storage, "time", c)
        monkeypatch.setattr(pkg.validation, "time", c)
    return c


def err(fn) -> tuple[str, str]:
    """The type name and message ``fn()`` raises (it must raise)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the exception is the output compared
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn} raised nothing")


def _normal(x, tmp: Path, pkg: str):
    """Paths under the package's own scratch directory and its name made
    comparable across the two runs."""
    if isinstance(x, str):
        return x.replace(str(tmp), "<tmp>").replace(pkg, "hops_tpu")
    if isinstance(x, dict):
        return {k: _normal(v, tmp, pkg) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_normal(v, tmp, pkg) for v in x)
    return x


def same(a, b, where: str = "output") -> None:
    """``a`` (JAX) and ``b`` (the port) equal: frames exactly, arrays by
    dtype, shape and value, containers element by element."""
    assert type(a) is type(b), f"{where}: {type(a).__name__} vs {type(b).__name__}"
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(b, a, obj=where)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(b, a, obj=where)
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{where}: keys {list(a)} vs {list(b)}"
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def run_both(scenario, tmp_path: Path, clock: _Clock | None = None):
    """``scenario(name, pkg, fs, tmp)`` in the JAX package, then in the
    port (each on the clock from its start, with a scratch directory of
    its own); their outputs must be equal. Returns the port's."""
    outs = {}
    for name, pkg in PKGS.items():
        if clock is not None:
            clock.reset()
        tmp = tmp_path / f"scratch_{name}"
        tmp.mkdir()
        fs = pkg.hsfs.connection().get_feature_store()
        outs[name] = _normal(scenario(name, pkg, fs, tmp), tmp, pkg.name)
    same(outs["jax"], outs["torch"])
    return outs["torch"]


def sales_df():
    return pd.DataFrame({
        "store_id": [1, 2, 3, 4],
        "sales": [10.0, 20.0, 30.0, 40.0],
        "region": ["n", "s", "n", "w"],
    })


def make_fg(fs, name="sales", online=False, **kw):
    fg = fs.create_feature_group(name, version=1, primary_key=["store_id"],
                                 online_enabled=online, **kw)
    fg.save(sales_df())
    return fg


def commits(fg) -> dict:
    """``commit_details`` without ``committedOn`` (the wall clock's)."""
    return {c: {k: v for k, v in m.items() if k != "committedOn"}
            for c, m in fg.commit_details().items()}


def schema(obj) -> list[dict]:
    return [f.to_dict() for f in obj.features]


# -- feature groups -----------------------------------------------------------


def sc_save_and_read(name, p, fs, tmp):
    return make_fg(fs).read()


def sc_schema_inferred(name, p, fs, tmp):
    fg = make_fg(fs)
    return schema(fg), fg.get_feature("store_id").primary


def sc_get_feature_group_roundtrip(name, p, fs, tmp):
    make_fg(fs)
    fg = fs.get_feature_group("sales", 1)
    return fg.primary_key, schema(fg), fg.read()


def sc_versioning(name, p, fs, tmp):
    make_fg(fs)
    fg2 = fs.create_feature_group("sales", primary_key=["store_id"])
    v = fg2.version
    fg2.save(sales_df())
    return v, fs.get_feature_group("sales").version, fs.get_feature_group("sales").read()


def sc_upsert_semantics(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.insert(pd.DataFrame({"store_id": [1, 9], "sales": [99.0, 9.0], "region": ["n", "e"]}))
    return fg.read(), commits(fg)


def sc_delete_record(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.commit_delete_record(pd.DataFrame({"store_id": [2]}))
    return fg.read(), commits(fg)


def sc_insert_overwrite(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.insert(pd.DataFrame({"store_id": [7], "sales": [1.0], "region": ["x"]}), overwrite=True)
    return fg.read()


def sc_commit_details_and_time_travel(name, p, fs, tmp):
    fg = make_fg(fs)
    first = list(fg.commit_details())[0]
    fg.insert(pd.DataFrame({"store_id": [1, 9], "sales": [99.0, 9.0], "region": ["n", "e"]}))
    return commits(fg), fg.read(wallclock_time=first), fg.read(wallclock_time=str(first))


def sc_read_changes_incremental(name, p, fs, tmp):
    fg = make_fg(fs)
    c1 = list(fg.commit_details())[0]
    fg.insert(pd.DataFrame({"store_id": [9], "sales": [9.0], "region": ["e"]}))
    c2 = list(fg.commit_details())[-1]
    return fg.read_changes(c1, c2)


def sc_statistics(name, p, fs, tmp):
    fg = make_fg(fs, statistics_config={"enabled": True, "histograms": True,
                                        "correlations": True})
    return fg.get_statistics()


def sc_tags(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.add_tag("owner", {"team": "ml", "pii": False})
    out = [fg.get_tag("owner"), fg.get_tags()]
    fg.delete_tag("owner")
    return out + [fg.get_tag("owner"), fg.get_tags()]


FEATURE_GROUP = [sc_save_and_read, sc_schema_inferred, sc_get_feature_group_roundtrip,
                 sc_versioning, sc_upsert_semantics, sc_delete_record, sc_insert_overwrite,
                 sc_commit_details_and_time_travel, sc_read_changes_incremental, sc_statistics,
                 sc_tags]


@pytest.mark.parametrize("scenario", FEATURE_GROUP, ids=lambda f: f.__name__[3:])
def test_feature_group_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


def test_upsert_and_time_travel_hold_in_the_port(tmp_path, clock):
    df, details = run_both(sc_upsert_semantics, tmp_path, clock)
    assert len(df) == 5 and df.set_index("store_id").loc[1, "sales"] == 99.0
    last = details[list(details)[-1]]
    assert last["rowsUpdated"] == 1 and last["rowsInserted"] == 1


# -- queries -------------------------------------------------------------------


def sc_select_filter(name, p, fs, tmp):
    fg = make_fg(fs)
    return fg.select(["store_id", "sales"]).filter(fg["sales"] > 15).read()


def sc_compound_filter(name, p, fs, tmp):
    fg = make_fg(fs)
    return [fg.select_all().filter((fg["sales"] > 15) & (fg["region"] == "n")).read(),
            fg.select_all().filter((fg["sales"] >= 40) | (fg["region"] == "n")).read()]


def sc_join_on_shared_pk(name, p, fs, tmp):
    make_fg(fs)
    fg1 = fs.get_feature_group("sales", 1)
    fg2 = fs.create_feature_group("stores", version=1, primary_key=["store_id"])
    fg2.save(pd.DataFrame({"store_id": [1, 2, 3], "size": [5, 6, 7]}))
    return fg1.select(["store_id", "sales"]).join(fg2.select(["size"])).read()


def sc_join_types_and_keys(name, p, fs, tmp):
    fg1 = make_fg(fs)
    fg2 = fs.create_feature_group("alt", version=1, primary_key=["sid"])
    fg2.save(pd.DataFrame({"sid": [1, 2], "bonus": [0.1, 0.2]}))
    return fg1.select_all().join(fg2.select_all(), left_on=["store_id"], right_on=["sid"],
                                 join_type="left").read()


def sc_query_as_of(name, p, fs, tmp):
    fg = make_fg(fs)
    c1 = list(fg.commit_details())[0]
    fg.insert(pd.DataFrame({"store_id": [1], "sales": [99.0], "region": ["n"]}))
    return fg.select_all().as_of(c1).read()


def sc_query_online_read(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.online_enabled = True
    fg._save_meta()
    fg.insert(pd.DataFrame({"store_id": [5], "sales": [50.0], "region": ["s"]}))
    q = fg.select(["store_id", "sales"]).filter(fg["sales"] > 15)
    return q.read(), q.read(online=True), fg.select_all().show(3, online=True)


def sc_query_online_join_and_as_of_guard(name, p, fs, tmp):
    fg1 = make_fg(fs, online=True)
    fg2 = fs.create_feature_group("stores2", version=1, primary_key=["store_id"],
                                  online_enabled=True)
    fg2.save(pd.DataFrame({"store_id": [1, 2], "size": [5, 6]}))
    q = fg1.select(["store_id", "sales"]).join(fg2.select(["size"]))
    return q.read(online=True), err(
        lambda: fg1.select_all().as_of("2020-01-01 00:00:00").read(online=True))


def sc_query_dataframe_type(name, p, fs, tmp):
    fg = make_fg(fs)
    return (fg.select(["store_id", "sales"]).read(dataframe_type="numpy"),
            fg.select(["store_id"]).read(dataframe_type="python"),
            err(lambda: fg.select_all().read(dataframe_type="spark")))


def sc_query_serialization_roundtrip(name, p, fs, tmp):
    fg = make_fg(fs)
    q = fg.select(["store_id", "sales"]).filter(fg["sales"] > 15)
    d = q.to_dict()
    q2 = p.hsfs.Query.from_dict(fs, {"feature_group": d["feature_group"],
                                     "features": d["features"], "joins": [], "as_of": None})
    return d, q2.read()


def sc_to_string(name, p, fs, tmp):
    fg = make_fg(fs)
    return fg.select(["sales"]).to_string(), fg.select_all().to_string()


QUERY = [sc_select_filter, sc_compound_filter, sc_join_on_shared_pk, sc_join_types_and_keys,
         sc_query_as_of, sc_query_online_read, sc_query_online_join_and_as_of_guard,
         sc_query_dataframe_type, sc_query_serialization_roundtrip, sc_to_string]


@pytest.mark.parametrize("scenario", QUERY, ids=lambda f: f.__name__[3:])
def test_query_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


def test_online_query_reads_the_online_store_in_the_port(tmp_path, clock):
    offline, online, shown = run_both(sc_query_online_read, tmp_path, clock)
    assert sorted(offline["store_id"]) == [2, 3, 4, 5]
    assert sorted(online["store_id"]) == [5] and len(shown) == 1


# -- online store --------------------------------------------------------------


def sc_online_write_and_serving_row(name, p, fs, tmp):
    fg = make_fg(fs, online=True)
    return [fg.get_serving_row({"store_id": i}) for i in (1, 2, 3, 4, 99)]


def sc_online_upsert_latest_wins(name, p, fs, tmp):
    fg = make_fg(fs, online=True)
    fg.insert(pd.DataFrame({"store_id": [2], "sales": [77.0], "region": ["s"]}))
    return fg.get_serving_row({"store_id": 2})


def sc_online_read(name, p, fs, tmp):
    return make_fg(fs, online=True).read(online=True).sort_values("store_id", ignore_index=True)


@pytest.mark.parametrize("scenario", [sc_online_write_and_serving_row,
                                      sc_online_upsert_latest_wins, sc_online_read],
                         ids=lambda f: f.__name__[3:])
def test_online_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- validation ----------------------------------------------------------------


def sc_rules_catalog(name, p, fs, tmp):
    conn = p.hsfs.connection()
    return conn.get_rules(), conn.get_rule("HAS_MIN")


def sc_expectation_warning(name, p, fs, tmp):
    fg = make_fg(fs)
    fs.create_expectation("sales_bounds", features=["sales"],
                          rules=[Rule[name](name="HAS_MIN", level="WARNING", min=15)]).save()
    fg.attach_expectation("sales_bounds")
    return fg.validate(), fg.get_validations()


def sc_strict_insert_blocked(name, p, fs, tmp):
    fg = fs.create_feature_group("gated", version=1, primary_key=["store_id"],
                                 validation_type="STRICT", expectations=["nonneg"])
    fs.create_expectation("nonneg", features=["sales"],
                          rules=[Rule[name](name="HAS_MIN", level="ERROR", min=0)]).save()
    fg.save(sales_df())
    return err(lambda: fg.insert(pd.DataFrame({"store_id": [5], "sales": [-1.0],
                                               "region": ["x"]}))), fg.get_validations()


def sc_contained_in_and_size(name, p, fs, tmp):
    fg = make_fg(fs)
    fs.create_expectation("shape", features=["region"], rules=[
        Rule[name](name="IS_CONTAINED_IN", level="ERROR", legal_values=["n", "s", "w"]),
        Rule[name](name="HAS_SIZE", level="ERROR", min=1, max=100),
    ]).save()
    fg.attach_expectation("shape")
    return fg.validate()


@pytest.mark.parametrize("scenario", [sc_rules_catalog, sc_expectation_warning,
                                      sc_strict_insert_blocked, sc_contained_in_and_size],
                         ids=lambda f: f.__name__[3:])
def test_validation_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


def test_strict_insert_is_blocked_in_the_port(tmp_path, clock):
    (kind, _), reports = run_both(sc_strict_insert_blocked, tmp_path, clock)
    assert kind == "DataValidationError" and reports[-1]["status"] == "FAILURE"


# -- training datasets ---------------------------------------------------------


def make_td(fs, fmt="parquet", **kw):
    fg = make_fg(fs)
    td = fs.create_training_dataset("tds", version=1, data_format=fmt, label=["sales"], **kw)
    td.save(fg.select(["store_id", "sales"]))
    return td


def sc_td_save_and_read(name, p, fs, tmp):
    td = make_td(fs)
    return td.read(), schema(td), td.get_statistics()


def sc_td_splits(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.insert(pd.DataFrame({"store_id": range(100), "sales": np.arange(100.0),
                            "region": ["n"] * 100}))
    td = fs.create_training_dataset("split_td", version=1, splits={"train": 0.7, "test": 0.3},
                                    seed=42)
    td.save(fg.select_all())
    return td.read("train"), td.read("test")


def sc_petastorm_roundtrip(name, p, fs, tmp):
    td = fs.create_training_dataset("peta", version=1, data_format="petastorm")
    images = [np.arange(12, dtype=np.float32).reshape(3, 4) + i for i in range(10)]
    td.save(pd.DataFrame({"image": pd.Series(images, dtype=object), "label": np.arange(10)}))
    back = td.read()
    return (list(back["image"]), back["label"],
            td.read(read_options={"columns": ["label"]}))


def sc_petastorm_row_group_reader(name, p, fs, tmp):
    td = fs.create_training_dataset("peta2", version=1, data_format="petastorm")
    images = [np.full((2, 2), i, np.float32) for i in range(20)]
    frame = pd.DataFrame({"image": pd.Series(images, dtype=object), "label": np.arange(20)})
    td.save(frame)
    d = td.dir / "data"
    for part in d.glob("part-*.parquet"):
        part.unlink()
    p.columnar.write_dataset(d, frame, row_group_size=5)
    reader = td.row_group_reader(shuffle=True, seed=1)
    return len(reader), list(reader), list(reader)


def sc_delta_append_overwrite_and_as_of(name, p, fs, tmp):
    td = fs.create_training_dataset("dl", version=1, data_format="delta")
    td.save(pd.DataFrame({"x": [1, 2]}))
    c1 = list(td.commit_details())[-1]
    td.insert(pd.DataFrame({"x": [3]}), overwrite=False)
    appended = td.read()
    td.insert(pd.DataFrame({"x": [9]}), overwrite=True)
    return (appended, td.read(), td.read(read_options={"as_of": c1}),
            {c: {k: v for k, v in m.items() if k != "committed_on"}
             for c, m in td.commit_details().items()},
            fs.create_training_dataset("dl2", version=1, data_format="HUDI").data_format)


def sc_query_replay(name, p, fs, tmp):
    make_td(fs)
    td2 = fs.get_training_dataset("tds", 1)
    return td2.query.to_dict(), td2.query.read(), td2.label, td2.serving_keys


def sc_numpy_feeder(name, p, fs, tmp):
    feeder = make_td(fs).tf_data(target_name="sales")
    return feeder.feature_names, list(feeder.numpy_iterator(batch_size=2, num_epochs=2, seed=1))


def sc_feeder_infinite_and_transform(name, p, fs, tmp):
    it = make_td(fs).tf_data(target_name="sales").numpy_iterator(
        batch_size=2, num_epochs=None, transform=lambda x, y: {"image": x, "label": y})
    return [next(it) for _ in range(5)]


def sc_feeder_start_step(name, p, fs, tmp):
    feeder = make_td(fs).tf_data(target_name="sales")
    kw = dict(batch_size=2, num_epochs=3, seed=7)
    return [list(feeder.numpy_iterator(**kw, start_step=k)) for k in (0, 1, 2, 3, 5)]


def sc_td_tags(name, p, fs, tmp):
    td = make_td(fs)
    td.add_tag("purpose", "unit-test")
    out = [td.get_tag("purpose"), td.get_tags()]
    td.delete_tag("purpose")
    return out + [td.get_tags()]


TRAINING_DATASET = [sc_td_save_and_read, sc_td_splits, sc_petastorm_roundtrip,
                    sc_petastorm_row_group_reader, sc_delta_append_overwrite_and_as_of,
                    sc_query_replay, sc_numpy_feeder, sc_feeder_infinite_and_transform,
                    sc_feeder_start_step, sc_td_tags]


@pytest.mark.parametrize("scenario", TRAINING_DATASET, ids=lambda f: f.__name__[3:])
def test_training_dataset_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


@pytest.mark.parametrize("fmt", ["parquet", "csv", "recordio"])
def test_training_dataset_formats_match_jax(fmt, tmp_path, clock):
    def scenario(name, p, fs, tmp):
        fg = make_fg(fs)
        td = fs.create_training_dataset(f"td_{fmt}", version=1, data_format=fmt,
                                        splits={"train": 0.5, "test": 0.5}, seed=3)
        td.save(fg.select_all())
        return (td.read("train"), td.read("test"),
                sorted(p.name for p in (td.dir / "train").iterdir()))

    train, test, files = run_both(scenario, tmp_path, clock)
    assert len(train) + len(test) == 4 and files


def test_feeder_process_sharded_matches_jax(tmp_path, clock):
    """One process: the process-sharded stream is the plain one (JAX's
    test holds its sharded arrays to its plain iterator), and the guard
    rails raise as JAX's do."""
    def scenario(name, p, fs, tmp):
        feeder = make_td(fs).tf_data(target_name="sales")
        return (list(feeder.numpy_iterator(batch_size=4, shuffle=False)),
                err(lambda: next(feeder.numpy_iterator(batch_size=4, process_sharded=True,
                                                       drop_remainder=False))))

    run_both(scenario, tmp_path, clock)
    fs = hsfs.connection().get_feature_store()
    feeder = fs.get_training_dataset("tds", 1).tf_data(target_name="sales")
    sharded = list(feeder.numpy_iterator(batch_size=4, shuffle=False, process_sharded=True))
    same(list(feeder.numpy_iterator(batch_size=4, shuffle=False)), sharded)
    with pytest.raises(ValueError, match="process_sharded"):
        next(feeder.numpy_iterator(batch_size=4, mesh=object()))


def test_get_serving_vector_matches_jax(tmp_path, clock):
    def scenario(name, p, fs, tmp):
        fg = fs.create_feature_group("olfg", version=1, primary_key=["store_id"],
                                     online_enabled=True)
        fg.save(sales_df())
        td = fs.create_training_dataset("serve_td", version=1, label=["sales"])
        td.save(fg.select(["store_id", "sales", "region"]))
        td.init_prepared_statement()
        return (td.serving_keys, td.get_serving_vector({"store_id": 3}),
                td.get_serving_vectors([{"store_id": i} for i in (1, 2, 4, 99)]))

    keys, vec, vecs = run_both(scenario, tmp_path, clock)
    assert keys == ["store_id"] and vec == [3, "n"] and vecs[-1] == [None, None]


# -- on-demand groups and SQL --------------------------------------------------


def sc_sql_over_feature_groups(name, p, fs, tmp):
    make_fg(fs)
    return fs.sql("SELECT region, SUM(sales) AS total FROM sales GROUP BY region "
                  "ORDER BY total DESC, region")


def sc_sql_version_pinned(name, p, fs, tmp):
    make_fg(fs)
    return fs.sql("SELECT COUNT(*) AS n FROM sales_1")


def sc_on_demand_feature_group(name, p, fs, tmp):
    make_fg(fs)
    odfg = fs.create_on_demand_feature_group(
        "sales_agg", version=1,
        query="SELECT region, SUM(sales) AS total FROM sales GROUP BY region ORDER BY region")
    odfg.save()
    return odfg.read(), fs.get_feature_group("sales_agg", 1).read()


def sc_dbapi_cursor(name, p, fs, tmp):
    make_fg(fs)
    cur = p.sql.connection(fs).cursor()
    cur.execute("SELECT store_id, sales FROM sales ORDER BY store_id")
    return cur.fetchall()


@pytest.mark.parametrize("scenario", [sc_sql_over_feature_groups, sc_sql_version_pinned,
                                      sc_on_demand_feature_group, sc_dbapi_cursor],
                         ids=lambda f: f.__name__[3:])
def test_sql_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- storage connectors --------------------------------------------------------


def sc_hopsfs_connector(name, p, fs, tmp):
    path = Path(p.hfs.project_path("Resources/ext.csv"))
    path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({"a": [1, 2]}).to_csv(path, index=False)
    fs.create_storage_connector("local", "HOPSFS", path="Resources")
    return fs.get_storage_connector("local").read(path="ext.csv")


def sc_s3_connector_read_and_ingest(name, p, fs, tmp):
    bucket = tmp / "demo-bucket"
    (bucket / "trips").mkdir(parents=True)
    pd.DataFrame({"trip_id": [1, 2, 3], "fare": [7.5, 12.0, 3.2]}).to_parquet(
        bucket / "trips" / "part-0.parquet")
    pd.DataFrame({"trip_id": [4], "fare": [9.9]}).to_csv(bucket / "extra.csv", index=False)
    fs.create_storage_connector("mybucket", "S3", bucket="demo-bucket", mount_point=str(bucket))
    c = fs.get_storage_connector("mybucket", "S3")
    fs.create_storage_connector("loose", "S3", mount_point=str(bucket))
    out = [c.read(path="extra.csv"), c.read(path="s3://demo-bucket/trips"),
           err(lambda: c.read(path="s3://other-bucket/trips")),
           err(lambda: c.read(path="s3://demo-bucket/../outside.csv")),
           err(lambda: c.read(path="s3://demo-bucket//etc/hostname.csv"))[0],
           err(lambda: fs.get_storage_connector("loose").read(path="s3://demo-bucket/extra.csv"))]
    fg = fs.create_feature_group("trips", version=1, primary_key=["trip_id"])
    fg.save(c.read(path="s3://demo-bucket/trips"))
    td = fs.create_training_dataset("trips_td", version=1, label=["fare"])
    td.save(fg.select_all())
    return out + [td.read()]


def sc_td_saved_through_s3_connector(name, p, fs, tmp):
    bucket = tmp / "td-bucket"
    bucket.mkdir()
    fs.create_storage_connector("tdsink", "S3", bucket="td-bucket", mount_point=str(bucket))
    fg = make_fg(fs)
    td = fs.create_training_dataset("s3td", version=1, label=["sales"],
                                    storage_connector=fs.get_storage_connector("tdsink"))
    td.save(fg.select(["store_id", "sales"]))
    again = fs.get_training_dataset("s3td", 1)
    return ((bucket / "s3td_1" / "data").exists(), (td.meta_dir / "data").exists(),
            again.storage_connector.name, again.read(),
            again.tf_data(target_name="sales").numpy_arrays())


def sc_td_rejects_sql_connector_sink(name, p, fs, tmp):
    fs.create_storage_connector("wh", "SNOWFLAKE", url="u")
    td = fs.create_training_dataset("whtd", version=1,
                                    storage_connector=fs.get_storage_connector("wh"))
    return err(lambda: td.save(pd.DataFrame({"a": [1]})))


def sc_s3_connector_without_mount_raises(name, p, fs, tmp):
    fs.create_storage_connector("far", "S3", bucket="remote-only")
    return err(lambda: fs.get_storage_connector("far").read(path="s3://remote-only/x.csv"))


def sc_snowflake_options(name, p, fs, tmp):
    fs.create_storage_connector("snow", "SNOWFLAKE", url="u", user="x", database="db",
                                schema="s", warehouse="w")
    c = fs.get_storage_connector("snow")
    return c.snowflake_connector_options(), err(c.read)


def sc_snowflake_account_url(name, p, fs, tmp):
    fs.create_storage_connector("snowreal", "SNOWFLAKE",
                                url="xy123.eu-west-1.snowflakecomputing.com")
    return err(lambda: fs.get_storage_connector("snowreal").read(query="select 1"))


def sc_snowflake_embedded_read_path(name, p, fs, tmp):
    db = tmp / "wh.db"
    conn = sqlite3.connect(db)
    conn.execute("create table trips (id int, fare real)")
    conn.executemany("insert into trips values (?, ?)", [(1, 7.5), (2, 11.0), (3, 3.25)])
    conn.commit()
    conn.close()
    fs.create_storage_connector("wh_snow", "SNOWFLAKE", url=f"jdbc:sqlite:{db}", user="svc",
                                database="wh", schema="public", warehouse="xs")
    c = fs.get_storage_connector("wh_snow", "SNOWFLAKE")
    ofg = fs.create_on_demand_feature_group(
        name="snow_trips", version=1, query="select id, fare from trips order by id",
        storage_connector=c)
    return c.read(query="select id, fare from trips where fare > 5 order by id"), ofg.read()


def sc_unknown_connector(name, p, fs, tmp):
    return err(lambda: fs.get_storage_connector("nope"))


CONNECTORS = [sc_hopsfs_connector, sc_s3_connector_read_and_ingest,
              sc_td_saved_through_s3_connector, sc_td_rejects_sql_connector_sink,
              sc_s3_connector_without_mount_raises, sc_snowflake_options,
              sc_snowflake_account_url, sc_snowflake_embedded_read_path, sc_unknown_connector]


@pytest.mark.parametrize("scenario", CONNECTORS, ids=lambda f: f.__name__[3:])
def test_connectors_match_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- review regressions --------------------------------------------------------


def sc_overwrite_purges_online_store(name, p, fs, tmp):
    fg = make_fg(fs, online=True)
    fg.insert(pd.DataFrame({"store_id": [7], "sales": [1.0], "region": ["x"]}), overwrite=True)
    return fg.get_serving_row({"store_id": 2}), fg.get_serving_row({"store_id": 7})


def sc_split_never_drops_rows(name, p, fs, tmp):
    fg = make_fg(fs)
    fg.insert(pd.DataFrame({"store_id": range(100, 746), "sales": np.arange(646.0),
                            "region": ["n"] * 646}))
    td = fs.create_training_dataset("rounding_td", version=1,
                                    splits={"train": 0.25164698, "test": 0.74835302}, seed=3)
    td.save(fg.select_all())
    return td.read("train"), td.read("test"), len(fg.read())


def sc_as_of_int_replay(name, p, fs, tmp):
    fg = make_fg(fs)
    c1 = list(fg.commit_details())[0]
    fg.insert(pd.DataFrame({"store_id": [1], "sales": [99.0], "region": ["n"]}))
    td = fs.create_training_dataset("asof_td", version=1)
    td.save(fg.select_all().as_of(c1))
    return fs.get_training_dataset("asof_td", 1).query.read()


def sc_strict_fg_can_delete(name, p, fs, tmp):
    fg = fs.create_feature_group("strictdel", version=1, primary_key=["store_id"],
                                 validation_type="STRICT", expectations=["del_amt"])
    fs.create_expectation("del_amt", features=["sales"],
                          rules=[Rule[name](name="HAS_MIN", level="ERROR", min=0)]).save()
    fg.save(sales_df())
    fg.commit_delete_record(pd.DataFrame({"store_id": [1]}))
    return fg.read()


def sc_filter_on_joined_unselected_column(name, p, fs, tmp):
    make_fg(fs)
    stores = fs.create_feature_group("stores", version=1, primary_key=["store_id"])
    stores.save(pd.DataFrame({"store_id": [1, 2, 3, 4], "size": [5, 50, 500, 5000],
                              "city": ["a", "b", "c", "d"]}))
    fg = fs.get_feature_group("sales")
    return fg.select_all().join(stores.select(["city"])).filter(stores["size"] > 100).read()


def sc_result_projected_to_selection(name, p, fs, tmp):
    fg = make_fg(fs)
    return fg.select(["store_id"]).filter(fg["sales"] > 15).read()


def sc_as_of_does_not_mutate_subquery(name, p, fs, tmp):
    fg = make_fg(fs)
    stores = fs.create_feature_group("stores2", version=1, primary_key=["store_id"])
    stores.save(pd.DataFrame({"store_id": [1, 2, 3, 4], "size": [1, 2, 3, 4]}))
    c1 = list(stores.commit_details())[0]
    sub = stores.select_all()
    joined = fg.select_all().join(sub).as_of(c1).read()
    stores.insert(pd.DataFrame({"store_id": [9], "size": [9]}))
    return joined, sub.read()


def sc_keyless_fg_statistics(name, p, fs, tmp):
    fg = fs.create_feature_group("events", version=1, statistics_config={
        "enabled": True, "histograms": False, "correlations": False})
    fg.save(pd.DataFrame({"v": [1.0, 2.0]}))
    fg.insert(pd.DataFrame({"v": [3.0]}))
    return fg.get_statistics()


def sc_split_categorical_encoding(name, p, fs, tmp):
    fg = fs.create_feature_group("cats", version=1, primary_key=["id"])
    rng = np.random.RandomState(0)
    n = 400
    cat = np.array(["aa", "bb", "cc", "dd"])[rng.randint(0, 4, n)]
    val = {"aa": 0.0, "bb": 1.0, "cc": 2.0, "dd": 3.0}
    fg.save(pd.DataFrame({"id": range(n), "cat": cat, "y": [val[c] for c in cat]}))
    td = fs.create_training_dataset("cats_td", version=1, splits={"train": 0.9, "test": 0.1},
                                    seed=1)
    td.save(fg.select(["cat", "y"]))
    return [td.tf_data(target_name="y", split=s).numpy_arrays() for s in ("train", "test")]


REGRESSIONS = [sc_overwrite_purges_online_store, sc_split_never_drops_rows,
               sc_as_of_int_replay, sc_strict_fg_can_delete,
               sc_filter_on_joined_unselected_column, sc_result_projected_to_selection,
               sc_as_of_does_not_mutate_subquery, sc_keyless_fg_statistics,
               sc_split_categorical_encoding]


@pytest.mark.parametrize("scenario", REGRESSIONS, ids=lambda f: f.__name__[3:])
def test_review_regressions_match_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- warehouse SQL ingest ------------------------------------------------------


def _external_db(tmp: Path) -> Path:
    db = tmp / "warehouse.db"
    con = sqlite3.connect(db)
    con.executescript(
        """
        CREATE TABLE orders (store_id INTEGER, amount REAL);
        INSERT INTO orders VALUES (1, 10.0), (1, 5.0), (2, 7.5), (3, 2.5);
        """
    )
    con.commit()
    con.close()
    return db


def sc_jdbc_connector_executes_query(name, p, fs, tmp):
    db = _external_db(tmp)
    c = p.connectors.create("wh", "JDBC", connection_string=f"jdbc:sqlite:{db}")
    return (c.read("SELECT store_id, SUM(amount) AS total FROM orders GROUP BY store_id"),
            p.connectors.get("wh", "JDBC").read("SELECT * FROM orders"))


def sc_jdbc_network_urls_still_raise(name, p, fs, tmp):
    c = p.connectors.create("rs", "REDSHIFT", connection_string="jdbc:redshift://cluster:5439/db")
    return err(lambda: c.read("SELECT 1"))


def sc_external_sql_to_training_dataset(name, p, fs, tmp):
    db = _external_db(tmp)
    wh = p.connectors.create("wh2", "JDBC", connection_string=f"jdbc:sqlite:{db}")
    odfg = fs.create_on_demand_feature_group(
        "order_totals", version=1,
        query="SELECT store_id, SUM(amount) AS total FROM orders GROUP BY store_id",
        storage_connector=wh)
    odfg.save()
    stores = fs.create_feature_group("stores", version=1, primary_key=["store_id"])
    stores.save(pd.DataFrame({"store_id": [1, 2, 3], "region": ["n", "s", "w"]}))
    joined = fs.sql("SELECT s.region, o.total FROM stores s "
                    "JOIN order_totals o ON s.store_id = o.store_id ORDER BY s.region")
    td = fs.create_training_dataset("wh_td", version=1)
    td.save(joined)
    return odfg.read(), joined, td.read()


@pytest.mark.parametrize("scenario", [sc_jdbc_connector_executes_query,
                                      sc_jdbc_network_urls_still_raise,
                                      sc_external_sql_to_training_dataset],
                         ids=lambda f: f.__name__[3:])
def test_jdbc_ingest_matches_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- builders ------------------------------------------------------------------


def sc_feature_group_builder(name, p, fs, tmp):
    B = p.builders
    fg = (fs.createFeatureGroup()
            .name("games_features")
            .version(1)
            .description("Features of games")
            .timeTravelFormat(B.TimeTravelFormat.HUDI)
            .primaryKeys(["home_team_id"])
            .partitionKeys(["score"])
            .statisticsConfig(B.StatisticsConfig(True, True, True))
            .build())
    fg.save(pd.DataFrame({"home_team_id": [1, 2], "score": [3, 4], "away_team_id": [5, 6]}))
    got = fs.getFeatureGroup("games_features", 1)
    return (got.primary_key, got.time_travel_format, got.statistics_config.to_dict(),
            got.read(), got.get_statistics())


def sc_training_dataset_builder(name, p, fs, tmp):
    make_fg(fs)
    td = (fs.createTrainingDataset()
            .name("tour_td")
            .version(1)
            .description("tour TD")
            .dataFormat(p.builders.DataFormat.CSV)
            .build())
    td.save(fs.get_feature_group("sales", 1).select_all())
    return td.data_format, td.description, td.read()


def sc_connection_builder(name, p, fs, tmp):
    return p.builders.HopsworksConnection.builder.build().get_feature_store().getName()


@pytest.mark.parametrize("scenario", [sc_feature_group_builder, sc_training_dataset_builder,
                                      sc_connection_builder], ids=lambda f: f.__name__[3:])
def test_builders_match_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- connector-backed training datasets ----------------------------------------


def sc_delete_with_unresolvable_connector(name, p, fs, tmp):
    fs.create_storage_connector("wh2", "SNOWFLAKE", url="u")
    td = fs.create_training_dataset("whtd2", version=1,
                                    storage_connector=fs.get_storage_connector("wh2"))
    td._save_meta()
    before = (td.meta_dir / "metadata.json").exists()
    td.delete()
    return before, td.meta_dir.exists()


def sc_resave_preserves_tags(name, p, fs, tmp):
    fg = make_fg(fs)
    td = fs.create_training_dataset("tagged", version=1, label=["sales"])
    td.save(fg.select(["store_id", "sales"]))
    td.add_tag("owner", "ml-team")
    td.insert(fg.select(["store_id", "sales"]))
    return fs.get_training_dataset("tagged", 1).get_tags()


def sc_load_with_missing_connector_entry(name, p, fs, tmp):
    bucket = tmp / "gone-bucket"
    bucket.mkdir()
    fs.create_storage_connector("gonesink", "S3", bucket="gone-bucket", mount_point=str(bucket))
    fg = make_fg(fs, name="gsales")
    td = fs.create_training_dataset("gtd", version=1,
                                    storage_connector=fs.get_storage_connector("gonesink"))
    td.save(fg.select(["store_id", "sales"]))
    p.connectors._registry_path().write_text("{}")
    again = fs.get_training_dataset("gtd", 1)
    out = err(again.read)
    again.delete()
    return out, again.meta_dir.exists()


@pytest.mark.parametrize("scenario", [sc_delete_with_unresolvable_connector,
                                      sc_resave_preserves_tags,
                                      sc_load_with_missing_connector_entry],
                         ids=lambda f: f.__name__[3:])
def test_connector_backed_training_datasets_match_jax(scenario, tmp_path, clock):
    run_both(scenario, tmp_path, clock)


# -- bias ----------------------------------------------------------------------


def bias_frame() -> pd.DataFrame:
    n = 100
    y = np.r_[np.ones(50), np.zeros(50), np.ones(50), np.zeros(50)].astype(int)
    yhat = y.copy()
    yhat[100:150] = np.r_[np.ones(25), np.zeros(25)].astype(int)
    return pd.DataFrame({"group": ["A"] * n + ["B"] * n, "label": y, "pred": yhat})


def sc_slice_metrics(name, p, fs, tmp):
    return p.bias.slice_metrics(bias_frame(), "label", "pred", "group")


def sc_disparity_and_report(name, p, fs, tmp):
    return p.bias.bias_report(bias_frame(), "label", "pred", "group")


def sc_threshold_binarizes_scores(name, p, fs, tmp):
    df = pd.DataFrame({"g": ["x", "x", "y", "y"], "label": [1, 0, 1, 0],
                       "score": [0.9, 0.2, 0.4, 0.1]})
    return (p.bias.slice_metrics(df, "label", "score", "g", threshold=0.5),
            p.bias.threshold_sweep(df, "label", "score", "g", thresholds=[0.3, 0.5]))


def sc_multi_column_slices(name, p, fs, tmp):
    df = bias_frame()
    df["age"] = (["young"] * 50 + ["old"] * 50) * 2
    m = p.bias.slice_metrics(df, "label", "pred", ["group", "age"])
    return m, p.bias.disparity(m, "tpr")


def sc_non_binary_labels_fail_fast(name, p, fs, tmp):
    df = pd.DataFrame({"g": ["A", "B"], "label": ["<=50K", ">50K"], "pred": [0, 1]})
    df2 = pd.DataFrame({"g": ["A", "B"], "label": [0, 1], "pred": [0.7, 0.4]})
    return (err(lambda: p.bias.slice_metrics(df, "label", "pred", "g")),
            err(lambda: p.bias.slice_metrics(df2, "label", "pred", "g")))


def sc_slice_column_collision(name, p, fs, tmp):
    df = pd.DataFrame({"count": ["A", "B"], "label": [0, 1], "pred": [0, 1]})
    return err(lambda: p.bias.slice_metrics(df, "label", "pred", "count"))


@pytest.mark.parametrize("scenario", [sc_slice_metrics, sc_disparity_and_report,
                                      sc_threshold_binarizes_scores, sc_multi_column_slices,
                                      sc_non_binary_labels_fail_fast, sc_slice_column_collision],
                         ids=lambda f: f.__name__[3:])
def test_bias_matches_jax(scenario, tmp_path):
    run_both(scenario, tmp_path)


def test_bias_report_known_answers_in_the_port(tmp_path):
    rep = run_both(sc_disparity_and_report, tmp_path)
    assert rep["demographic_parity"]["gap"] == pytest.approx(0.25)
    assert rep["equal_opportunity"]["gap"] == pytest.approx(0.5)


# -- one store, two packages ---------------------------------------------------


@pytest.fixture
def shared(tmp_path, monkeypatch):
    """Both packages pointed at ONE workspace."""
    ws = tmp_path / "shared"
    monkeypatch.setenv("HOPS_TPU_WORKSPACE", str(ws))
    jax_config.configure(workspace=str(ws), project="testproj")
    config.configure(workspace=str(ws), project="testproj")
    return ws


OTHER = {"jax": "torch", "torch": "jax"}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_feature_group_reads_across_packages(writer, shared, clock):
    """A feature group of two commits, with statistics, an expectation
    and an online store, written by one package, reads the same in the
    other: frames (latest and as_of), commits, schema, statistics,
    validations and serving rows from the native online store."""
    w, r = PKGS[writer], PKGS[OTHER[writer]]
    fs_w = w.hsfs.connection().get_feature_store()
    fs_w.create_expectation("nonneg", features=["sales"],
                            rules=[Rule[writer](name="HAS_MIN", level="ERROR", min=0)]).save()
    fg = fs_w.create_feature_group("sales", version=1, primary_key=["store_id"],
                                   online_enabled=True, expectations=["nonneg"],
                                   validation_type="ALL", statistics_config={
                                       "enabled": True, "histograms": True,
                                       "correlations": True})
    fg.save(sales_df())
    fg.insert(pd.DataFrame({"store_id": [2, 9], "sales": [25.0, 9.0], "region": ["s", "e"]}))
    first = list(fg.commit_details())[0]
    want = (fg.read(), fg.read(wallclock_time=first), commits(fg), schema(fg),
            fg.get_statistics(), fg.get_validations(),
            [fg.get_serving_row({"store_id": i}) for i in (1, 2, 9, 5)])
    fg.online_store().close()

    got_fg = r.hsfs.connection().get_feature_store().get_feature_group("sales", 1)
    got = (got_fg.read(), got_fg.read(wallclock_time=first), commits(got_fg), schema(got_fg),
           got_fg.get_statistics(), got_fg.get_validations(),
           [got_fg.get_serving_row({"store_id": i}) for i in (1, 2, 9, 5)])
    got_fg.online_store().close()
    same(want, got)
    assert want[-1][1]["sales"] == 25.0 and want[-1][-1] is None


@pytest.mark.parametrize("fmt", ["parquet", "csv", "recordio"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_training_dataset_reads_across_packages(writer, fmt, shared, clock):
    """A training dataset with splits, written by one package, reads the
    same in the other: every split's frame, the schema, the replayed
    query and the feeder's arrays and batches."""
    w, r = PKGS[writer], PKGS[OTHER[writer]]
    fs_w = w.hsfs.connection().get_feature_store()
    fg = fs_w.create_feature_group("trips", version=1, primary_key=["trip_id"])
    rng = np.random.default_rng(3)
    fg.save(pd.DataFrame({"trip_id": np.arange(40), "hour": rng.integers(0, 24, 40),
                          "fare": rng.gamma(2.0, 2.0, 40), "zone": rng.integers(0, 5, 40),
                          "tip": rng.integers(0, 2, 40)}))
    td = fs_w.create_training_dataset("trips_td", version=1, data_format=fmt, label=["tip"],
                                      splits={"train": 0.75, "test": 0.25}, seed=5)
    td.save(fg.select_all())

    def read(fs):
        t = fs.get_training_dataset("trips_td", 1)
        feeder = t.tf_data(target_name="tip", split="train", feature_names=["fare", "hour"])
        return (t.read("train"), t.read("test"), schema(t), t.query.read(),
                feeder.numpy_arrays(),
                list(feeder.numpy_iterator(batch_size=8, num_epochs=2, seed=1)))

    same(read(fs_w), read(r.hsfs.connection().get_feature_store()))
