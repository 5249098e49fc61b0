"""Chicago-Taxi wide-and-deep pipeline — the TFX Trainer twin, end-to-end.

Counterpart of ``examples/taxi_pipeline.py`` (BASELINE.md config 5: the
reference's README points at TFX Chicago-Taxi notebooks, absent from the
snapshot; the required capability is the Trainer-equivalent pipeline).
It runs the full data-to-serving path: synthetic taxi trips → feature
group (with a validation expectation) → training dataset with splits →
wide-and-deep training on the card via ``experiment.launch`` → model
registry (the module's ``state_dict`` beside its fields).

Usage: ``python examples_torch/taxi_pipeline.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd
import torch

import hops_tpu_torch.featurestore as hsfs
from hops_tpu_torch import experiment
from hops_tpu_torch.featurestore.validation import Rule
from hops_tpu_torch.modelrepo import registry
from hops_tpu_torch.models import common
from hops_tpu_torch.models.widedeep import WideAndDeep

VOCAB = [24, 7, 100]  # hour, weekday, pickup-zone
NUM_DENSE = 3  # distance, fare, duration


def synthesize_trips(n=2000, seed=3) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    distance = rng.gamma(2.0, 2.0, n)
    duration = distance * rng.uniform(2, 4, n)
    fare = 3 + 2.2 * distance + rng.normal(0, 1, n).clip(-2, 2)
    df = pd.DataFrame(
        {
            "trip_id": np.arange(n),
            "hour": rng.integers(0, 24, n),
            "weekday": rng.integers(0, 7, n),
            "zone": rng.integers(0, 100, n),
            "distance": distance,
            "fare": fare,
            "duration": duration,
        }
    )
    # Label: generous tipper (>20% of fare), correlated with hour+distance.
    tip_rate = 0.1 + 0.05 * (df.hour > 18) + 0.02 * (distance > 5) + rng.normal(0, 0.05, n)
    df["big_tipper"] = (tip_rate > 0.15).astype(int)
    return df


def build_features() -> "hsfs.TrainingDataset":
    fs = hsfs.connection().get_feature_store()
    exp = fs.create_expectation(
        "fare_positive", features=["fare"], rules=[Rule(name="HAS_MIN", level="ERROR", min=0)]
    ).save()
    fg = fs.create_feature_group(
        "taxi_trips",
        version=1,
        primary_key=["trip_id"],
        expectations=[exp],
        validation_type="ALL",
        description="synthetic Chicago-Taxi-shaped trips",
    )
    fg.save(synthesize_trips())
    td = fs.create_training_dataset(
        "taxi_tips", version=1, data_format="parquet", splits={"train": 0.8, "test": 0.2}
    )
    td.save(fg.select_all())
    return td


def train_wrapper(device=None):
    fs = hsfs.connection().get_feature_store()
    td = fs.get_training_dataset("taxi_tips", 1)
    train_df = td.read("train")

    def to_batch(df):
        return {
            "dense": torch.tensor(df[["distance", "fare", "duration"]].to_numpy(np.float32)),
            "categorical": torch.tensor(df[["hour", "weekday", "zone"]].to_numpy(np.int64)),
        }, torch.tensor(df["big_tipper"].to_numpy(np.int64))

    feats, labels = to_batch(train_df)
    model = WideAndDeep(vocab_sizes=VOCAB, dtype="float32", num_dense=NUM_DENSE,
                        device=device, seed=0)
    dev = model.device
    feats = {k: v.to(dev) for k, v in feats.items()}
    labels = labels.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    n = len(labels)
    bs = min(256, n)  # full batches only, as the JAX step's static shapes
    for epoch in range(5):
        for i in range(0, n - bs + 1, bs):
            sl = slice(i, i + bs)
            logits = model({k: v[sl] for k, v in feats.items()})
            loss = common.cross_entropy_loss(logits, labels[sl])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    test_feats, test_labels = to_batch(td.read("test"))
    with torch.no_grad():
        test_logits = model({k: v.to(dev) for k, v in test_feats.items()})
    acc = float(common.accuracy(test_logits, test_labels.to(dev)))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(model.state_dict(), Path(tmp) / "widedeep.pt")
        (Path(tmp) / "widedeep.json").write_text(json.dumps(
            {"vocab_sizes": VOCAB, "num_dense": NUM_DENSE, "dtype": "float32"}))
        registry.export(tmp, "taxi_widedeep", metrics={"accuracy": acc})
    return {"accuracy": acc, "final_loss": float(loss.detach())}


def main(*, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    td = build_features()
    logdir, metrics = experiment.launch(train_wrapper, args={"device": dev},
                                        name="taxi_trainer", metric_key="accuracy")
    best = registry.get_best_model("taxi_widedeep", "accuracy", registry.Metric.MAX)
    print(
        f"taxi pipeline complete: td_train={len(td.read('train'))} "
        f"accuracy={metrics['accuracy']:.3f} model_version={best['version']}"
    )
    return {"metrics": metrics, "best": best}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
