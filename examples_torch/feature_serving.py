"""Online feature serving tour — the recommender scenario end to end.

Counterpart of ``examples/feature_serving.py``. The reference's feature-vector serving loop
(feature_vector_model_serving.ipynb): engineer features into a feature
group, keep the online view consistent through the streaming layer, and
serve models whose requests carry only entity IDs — the platform joins
the features. Here that is: offline feature group -> pubsub topic ->
write-through :class:`Materializer` -> :class:`ShardedOnlineStore` ->
:class:`FeatureJoinPredictor` in front of a WideAndDeep recommender.

The recommender runs on ``--device`` (default: the card).

Run: ``python examples_torch/feature_serving.py [--device cpu]``
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd


def main(argv: list[str] | None = None, *, device=None) -> dict:
    import argparse

    import torch

    import hops_tpu_torch.featurestore as hsfs
    from hops_tpu_torch.featurestore.online_serving import (
        FeatureJoinPredictor,
        Materializer,
        ShardedOnlineStore,
    )
    from hops_tpu_torch.messaging import pubsub
    from hops_tpu_torch.models.widedeep import WideAndDeep, batch_from_vectors
    from hops_tpu_torch.runtime.devices import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    fs = hsfs.connection().get_feature_store()

    # 1. Offline feature engineering: a versioned, commit-logged group.
    n, num_dense = 32, 3
    rs = np.random.RandomState(0)
    df = pd.DataFrame({
        "user_id": np.arange(n),
        "d0": rs.randn(n), "d1": rs.randn(n), "d2": rs.randn(n),
        "c0": rs.randint(0, 8, n), "c1": rs.randint(0, 8, n),
    })
    fg = fs.create_feature_group("rec_users", version=1, primary_key=["user_id"])
    fg.save(df)

    # 2. Write-through materialization: the topic is the one source of
    # truth for the online view; the daemon keeps it consistent.
    store = ShardedOnlineStore("rec_users", 1, primary_key=["user_id"], shards=4)
    topic = pubsub.create_topic("rec-users-updates")
    producer = pubsub.Producer(topic)
    t_mark = time.time()
    for rec in df.to_dict(orient="records"):
        producer.send({**rec, "event_time": t_mark})
    daemon = Materializer(store, topic, event_time="event_time").start()
    drained = daemon.drain(10.0)
    daemon.stop()

    online_matches_offline = drained and all(
        store.get({"user_id": int(u)}) is not None for u in df["user_id"]
    )

    # 3. Serving-time joins: requests carry entity IDs; the predictor
    # joins the online rows into model-ready vectors.
    order = ["d0", "d1", "d2", "c0", "c1"]
    model = WideAndDeep(vocab_sizes=(8, 8), embed_dim=4, hidden=(16,),
                        dtype="float32", num_dense=num_dense, device=dev, seed=0)

    def widedeep_predict(vectors):
        with torch.no_grad():
            out = model(batch_from_vectors(vectors, num_dense=num_dense)).cpu()
        return [list(map(float, row)) for row in out]

    predictor = FeatureJoinPredictor(
        widedeep_predict,
        {"groups": [{"name": "rec_users", "version": 1,
                     "primary_key": ["user_id"], "features": order}],
         "order": order, "missing": "default"},
        model="rec",
        stores={"rec_users": store},
    )
    predictions = predictor.predict(
        [{"user_id": 1}, {"user_id": 17}, {"user_id": 30}]
    )
    lag = store.freshness_lag_s()
    store.close()

    print(f"feature serving tour complete: {n} entities online, "
          f"freshness lag {lag:.3f}s, predictions={predictions}")
    return {
        "entities": n,
        "predictions": predictions,
        "online_matches_offline": online_matches_offline,
        "freshness_lag_s": lag,
    }


if __name__ == "__main__":
    main()
