"""Text-generation serving: train a toy LM → export → serve → generate.

Counterpart of ``examples/lm_serving.py``. The reference's serving story
is one-shot classifier REST calls (notebooks/ml/End_To_End_Pipeline/
sklearn/IrisClassification_And_Serving_SKLearn.ipynb, SURVEY.md §2.5);
this example runs the same export/create/start/infer lifecycle with the
framework's OWN model family: a ``TransformerLM`` trained on the card on
a cyclic token pattern (the flash kernel forward and its two backward
kernels, head_dim 16 zero-padded to 64), exported with its next-token
accuracy as a ``state_dict`` beside its config, and served through the
``class Predict`` Python-predictor contract, where each request runs
KV-cached ``generate()`` on the card (the flash kernel's prefill and the
decode kernel's steps, ``eos_id`` termination).

Usage: ``python examples_torch/lm_serving.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

MODEL_NAME = "cycle_lm"

# Tokens 2..9 cycle; 0 is pad, 1 is eos (never seen in training data,
# so greedy decoding follows the cycle and never stops early).
VOCAB = 16
CYCLE = list(range(2, 10))

MODEL_CONFIG = dict(
    vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
    max_decode_len=64,
)

PREDICTOR_SCRIPT = '''
"""Python model server hosting KV-cached generation (contract:
reference iris_flower_classifier.py:1-27 — same class, generative model)."""
import json
from pathlib import Path

import torch

from hops_tpu_torch.models.generation import generate
from hops_tpu_torch.models.transformer import TransformerLM


class Predict:
    def __init__(self):
        d = Path(__file__).parent
        cfg = json.loads((d / "config.json").read_text())
        self.device = torch.device(cfg.pop("device"))
        self.model = TransformerLM(**cfg, dtype="float32", device=self.device)
        self.model.load_state_dict(
            torch.load(d / "model.pt", map_location=self.device, weights_only=True))

    def predict(self, instances):
        """instances: list of prompt token-id lists -> list of generated
        continuation token-id lists. Lengths MAY differ: with server-side
        batching the server coalesces prompts from different clients into
        one call, so prompts are grouped by length and each group runs
        one KV-cached pass (grouping, not padding — left-pad would shift
        a causal LM's positions)."""
        out = [None] * len(instances)
        by_len = {}
        for i, p in enumerate(instances):
            by_len.setdefault(len(p), []).append(i)
        for n, idxs in by_len.items():
            prompt = torch.tensor([instances[i] for i in idxs], dtype=torch.long)
            with torch.no_grad():
                gen = generate(
                    self.model, prompt, max_new_tokens=16, temperature=0.0, eos_id=1,
                    pad_id=0, device=self.device,
                )
            for row, i in enumerate(idxs):
                out[i] = gen[row, n:].tolist()
        return out
'''


def build(params=None, *, device=None):
    """The LM on ``device`` with fp32 weights: ``params`` (a flax
    parameter tree or flat dict, e.g. the JAX example's) or
    ``random_params(seed=0)``."""
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM

    params = random_params(**MODEL_CONFIG, seed=0) if params is None else params
    return TransformerLM(dtype="float32", **MODEL_CONFIG, device=device).load_flax(params)


def eval_tokens():
    """A held-out rotation of the cycle, ``(1, 17)``."""
    import numpy as np

    cyc = np.array(CYCLE)
    return cyc[(3 + np.arange(17)) % len(CYCLE)][None]


def _train(steps: int = 60, *, params=None, device=None):
    """``(model, accuracy)``: the LM trained ``steps`` Adam steps on
    rotations of the cycle, or with ``params`` those weights as they are
    (no training); next-token accuracy on :func:`eval_tokens`."""
    import numpy as np
    import torch

    from hops_tpu_torch.models import common
    from hops_tpu_torch.models.transformer import make_lm_train_step

    model = build(params, device=device)
    if params is None:
        state = common.create_train_state(
            model, optimizer=torch.optim.Adam(model.parameters(), lr=3e-3))
        rs = np.random.RandomState(0)
        step = make_lm_train_step()
        cyc = np.array(CYCLE)
        for _ in range(steps):
            starts = rs.randint(0, len(CYCLE), size=(8,))
            tokens = np.stack([cyc[(s + np.arange(17)) % len(CYCLE)] for s in starts])
            state, metrics = step(state, {"tokens": tokens})

    ev = torch.as_tensor(eval_tokens(), device=model.device)
    with torch.no_grad():
        logits = model(ev[:, :-1])
    acc = float((logits.argmax(-1) == ev[:, 1:]).float().mean())
    return model, acc


def main(*, params=None, device=None) -> dict:
    import threading

    import torch

    from hops_tpu_torch.modelrepo import registry, serving
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    model, acc = _train(params=params, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(model.state_dict(), Path(tmp) / "model.pt")
        (Path(tmp) / "config.json").write_text(json.dumps({**MODEL_CONFIG, "device": str(dev)}))
        (Path(tmp) / "predictor.py").write_text(PREDICTOR_SCRIPT)
        meta = registry.export(tmp, MODEL_NAME, metrics={"next_token_accuracy": acc})

    serving.create_or_update(
        MODEL_NAME, model_name=MODEL_NAME, model_version=meta["version"],
        model_server="PYTHON",
        # Concurrent clients coalesce into one predictor pass per window.
        batching_enabled=True, batching_config={"max_batch_size": 16,
                                                "timeout_ms": 10},
    )
    serving.start(MODEL_NAME)
    try:
        prompt = CYCLE[:4]
        resp = serving.make_inference_request(
            MODEL_NAME,
            {"signature_name": "serving_default", "instances": [prompt]},
        )
        continuation = resp["predictions"][0]

        # Concurrent clients with DIFFERENT prompt lengths: the server-
        # side batcher coalesces them; the predictor groups by length.
        ragged = {}

        def client(key, p):
            ragged[key] = serving.make_inference_request(
                MODEL_NAME, {"instances": [p]})["predictions"][0]

        threads = [
            threading.Thread(target=client, args=("short", CYCLE[:2])),
            threading.Thread(target=client, args=("long", CYCLE[:6])),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(
            f"lm served: next-token acc={acc:.3f} prompt={prompt} "
            f"continuation={continuation} ragged_ok={sorted(ragged)}"
        )
        return {"accuracy": acc, "prompt": prompt, "continuation": continuation,
                "ragged": ragged}
    finally:
        serving.stop(MODEL_NAME)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
