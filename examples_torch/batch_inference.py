"""Batch inference at dataset scale: registry model → sharded predict → results dataset.

Counterpart of ``examples/batch_inference.py``, the twin of the
reference's batch-inference notebook
(notebooks/ml/Inference/Batch_Inference_Imagenet_Spark.ipynb:283-325,
SURVEY.md §2.5): there, an image DataFrame is repartitioned to
``util.num_executors()*3``, the model is broadcast per partition, and
``mapPartitions`` classifies each image, collecting (image, label,
probability) rows. Here the model comes out of the versioned registry
once, the forward runs data-parallel on the strategy's device
(``modelrepo.batch``), the host streams fixed-shape chunks (the ragged
tail padded), and the predictions land in a parquet dataset under the
project workspace, queryable like any other.

Usage: ``python examples_torch/batch_inference.py [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd
import torch

from hops_tpu_torch.modelrepo import batch, registry
from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import params_to_flax, random_params
from hops_tpu_torch.models.mnist import CNN
from hops_tpu_torch.parallel.strategy import Strategy
from hops_tpu_torch.runtime import fs as hfs

MODEL_NAME = "digits_cnn_batch"
LM_CONFIG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, dtype="float32",
                 attention_impl="reference", max_decode_len=64)


def train_and_register(seed: int = 0, device=None) -> dict:
    """A quick trained classifier in the registry (the notebook assumes
    a pre-trained ImageNet model already exported; here we make one)."""
    try:
        from examples_torch.mnist_pipeline import synthetic_mnist
    except ImportError:  # run directly as a script from examples_torch/
        from mnist_pipeline import synthetic_mnist

    data = synthetic_mnist(seed=seed)
    model = CNN(dtype="float32", device=device, seed=seed)
    state = common.create_train_state(model, learning_rate=1e-3)
    step = common.make_train_step()
    for i in range(0, 512, 64):
        batch_i = {k: v[i : i + 64] for k, v in data.items()}
        state, metrics = step(state, batch_i)
    acc = float(metrics["accuracy"])
    registry.save_classifier("CNN", {"dtype": "float32"}, params_to_flax(model), MODEL_NAME,
                             metrics={"accuracy": acc})
    return {"accuracy": acc}


def main(n_images: int = 300, per_chip_batch: int = 32, *, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    train_and_register(device=dev)
    best = registry.get_best_model(MODEL_NAME, "accuracy", registry.Metric.MAX)

    # The "image dataset": ids + pixels, deliberately not a multiple of
    # the chunk size so the padded tail path runs.
    rng = np.random.RandomState(1)
    ids = np.arange(n_images)
    images = rng.rand(n_images, 28, 28, 1).astype(np.float32)

    logits = batch.predict_with_model(
        MODEL_NAME, images, version=best["version"], per_chip_batch=per_chip_batch,
        strategy=Strategy(device=dev),
    )
    probs = torch.softmax(torch.as_tensor(logits), dim=-1).numpy()
    top1 = probs.argmax(axis=-1)

    # Reference collects (image, prediction, probability) rows into a
    # DataFrame; here they become a parquet dataset in the workspace.
    out = pd.DataFrame(
        {"image_id": ids, "prediction": top1, "probability": probs.max(axis=-1)}
    )
    dest = hfs.project_path("Resources/batch_predictions.parquet")
    hfs.mkdir("Resources")
    out.to_parquet(dest, index=False)

    readback = pd.read_parquet(dest)
    print(
        f"batch inference complete: model v{best['version']} over "
        f"{n_images} images in chunks of {per_chip_batch}/chip -> "
        f"{len(readback)} predictions at {dest}"
    )

    # The LM counterpart: registry LM -> offline continuous batching
    # (budget-sorted waves, one fused prefill+decode dispatch each —
    # modelrepo.batch.lm_generate_with_model / LMEngine.run_offline).
    registry.save_lm(LM_CONFIG, random_params(**LM_CONFIG, seed=0), "batch-lm-demo",
                     metrics={"loss": 1.0})
    prompts = [rng.randint(1, 64, (n,)) for n in (4, 7, 3)]
    gens = batch.lm_generate_with_model(
        "batch-lm-demo", prompts, max_new_tokens=[6, 4, 8], slots=2, device=dev
    )
    print(f"LM batch generate: {[len(g) for g in gens]} tokens per prompt "
          "(offline waves)")
    return {"rows": len(readback), "version": best["version"], "path": dest,
            "lm_generated": [len(g) for g in gens]}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
