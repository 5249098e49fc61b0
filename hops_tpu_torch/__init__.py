"""hops_tpu_torch — the PyTorch/CUDA port of ``hops_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference: each module here mirrors the path of its counterpart under
``hops_tpu/`` and is held against it by ``tests/test_torch_*.py``.

The port serves the TransformerLM through the continuous-batching engine
(``modelrepo.serving.LMEnginePredictor`` -> ``modelrepo.lm_engine`` ->
``models.transformer``; dense, int8 and paged KV caches) and trains it,
on seven CUDA kernels written for Hopper (``ops/csrc``); it runs
experiments through ``experiment.launch`` with preemption-safe
checkpoints (``runtime.checkpoint``, ``runtime.preemption``) and trains
the classifiers of ``models.mnist`` and ``models.resnet``.

The package imports ``torch`` and numpy only — never ``jax``, ``flax``,
``optax``, ``orbax`` or ``hops_tpu`` — and its entry points run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
