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
the classifiers of ``models.mnist`` and ``models.resnet``. The HTTP
serving host (``modelrepo.serving``, ``modelrepo.serving_host``) serves
both behind the TF-Serving REST contract. Hyperparameter searches
(``experiment.grid_search``, ``differential_evolution``, ``lagom`` on
``search`` with heartbeats over ``messaging.rpc``) run each trial on its
own group of devices, fed by the input pipeline (``featurestore.loader``
over the native RecordIO reader of ``native``, prefetched onto the
card by ``featurestore.feed``). The feature store (``featurestore``:
feature groups with time travel, queries, validation, statistics,
training datasets that feed the loader, the sharded online store kept
by write-through materialization; ``sql``: SQL over feature groups)
builds the training data, and the serving host's ``feature_config``
joins online rows into model inputs for requests that carry entity
IDs only.

The package imports ``torch`` and numpy only — never ``jax``, ``flax``,
``optax``, ``orbax`` or ``hops_tpu`` — and its entry points run on the
card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
