"""End-to-end pipeline: train → register → query best → serve → infer.

Counterpart of ``examples/mnist_pipeline.py``, the twin of the
reference's flagship notebook (notebooks/ml/End_To_End_Pipeline/
tensorflow/model_repo_and_serving.ipynb, SURVEY.md §2.5): a wrapper
function trains the MNIST FFN on synthetic data on the card via
``experiment.launch``, exports it to the model registry as a classifier
bundle with metrics, the best version is looked up by metric, served on
the card, and hit with a TF-Serving-style inference request whose
request/response pair lands on the serving's pubsub topic.

Usage: ``python examples_torch/mnist_pipeline.py [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from hops_tpu_torch import experiment
from hops_tpu_torch.messaging import pubsub
from hops_tpu_torch.modelrepo import registry, serving
from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import params_to_flax
from hops_tpu_torch.models.mnist import FFN

MODEL_NAME = "mnist_ffn"


def synthetic_mnist(n=512, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.rand(n, 28, 28, 1).astype(np.float32),
        "label": rng.randint(0, 10, n),
    }


def train_wrapper(device=None):
    data = synthetic_mnist()
    model = FFN(dtype="float32", device=device, seed=0)
    state = common.create_train_state(model, learning_rate=1e-3)
    step = common.make_train_step()
    for epoch in range(3):
        for i in range(0, 512, 64):
            batch = {k: v[i : i + 64] for k, v in data.items()}
            state, metrics = step(state, batch)
    acc = float(metrics["accuracy"])
    registry.save_classifier("FFN", {"dtype": "float32"}, params_to_flax(model), MODEL_NAME,
                             metrics={"accuracy": acc})
    return {"accuracy": acc}


def main(*, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    logdir, metrics = experiment.launch(train_wrapper, args={"device": dev},
                                        name="mnist_pipeline", metric_key="accuracy")
    best = registry.get_best_model(MODEL_NAME, "accuracy", registry.Metric.MAX)
    serving.create_or_update(MODEL_NAME, model_name=MODEL_NAME, model_version=best["version"],
                             device=dev)
    serving.start(MODEL_NAME)
    try:
        payload = {
            "signature_name": "serving_default",
            "instances": np.zeros((2, 28, 28, 1)).tolist(),
        }
        resp = serving.make_inference_request(MODEL_NAME, payload)
        consumer = pubsub.Consumer(serving.get_kafka_topic(MODEL_NAME), from_beginning=True)
        logged = consumer.poll()
        print(
            f"pipeline complete: acc={metrics['accuracy']:.3f} "
            f"version={best['version']} preds={len(resp['predictions'])} "
            f"inference_log_records={len(logged)}"
        )
        return {"metrics": metrics, "best": best, "predictions": resp["predictions"],
                "logged": len(logged)}
    finally:
        serving.stop(MODEL_NAME)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
