"""Async parallel-trial search — the maggy equivalent (counterpart of
``hops_tpu/search``, SURVEY.md §2.4).

Surface mirrored from the reference:

- :class:`Searchspace` with INTEGER/DOUBLE/DISCRETE/CATEGORICAL types
  (maggy-fashion-mnist-example.ipynb:124-130)
- trial functions take hyperparameters as kwargs plus ``reporter`` and
  return a scalar metric (or dict)
- :func:`~hops_tpu_torch.search.drivers.lagom` async driver: optimizer
  loop + heartbeat RPC + early stopping + LOCO ablation
- ``grid_search`` / ``differential_evolution`` drivers backing
  ``hops_tpu_torch.experiment``'s entry points (SURVEY.md §2.3)

Trials are scheduled onto disjoint groups of devices (default: every
visible card, one a trial), each trial thread inside its group's
``runtime.devices.trial_scope`` — task parallelism over the cards
(SURVEY.md §2.9 row 4). Everything but the drivers' device placement is
a copy of the JAX package's modules.
"""

from hops_tpu_torch.search.ablation import AblationStudy  # noqa: F401
from hops_tpu_torch.search.drivers import (  # noqa: F401
    differential_evolution,
    grid_search,
    lagom,
)
from hops_tpu_torch.search.earlystop import MedianEarlyStopper  # noqa: F401
from hops_tpu_torch.search.optimizers import (  # noqa: F401
    ASHA,
    DifferentialEvolution,
    GridSearch,
    RandomSearch,
)
from hops_tpu_torch.search.reporter import Reporter, TrialStopped  # noqa: F401
from hops_tpu_torch.search.searchspace import Searchspace  # noqa: F401
