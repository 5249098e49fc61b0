"""Experiment layer — launchers, registry, tensorboard (counterpart of
``hops_tpu/experiment``).

``launch`` runs a wrapper function holding a whole training program in
a run directory of its own and registers the run; ``mirrored``,
``collective_all_reduce`` and ``parameter_server`` run it inside a
data-parallel strategy's scope in every process of the run.
``grid_search``, ``differential_evolution`` and ``lagom`` run
hyperparameter searches through ``hops_tpu_torch.search``, each trial on
its own group of devices.
"""

from hops_tpu_torch.experiment import registry, tensorboard  # noqa: F401
from hops_tpu_torch.experiment.core import (  # noqa: F401
    collective_all_reduce,
    launch,
    mirrored,
    parameter_server,
)


def grid_search(*args, **kwargs):
    """Exhaustive cartesian hparam sweep (reference:
    ``experiment.grid_search``, grid_search_fashion_mnist.ipynb:311)."""
    from hops_tpu_torch.search.drivers import grid_search as _gs

    return _gs(*args, **kwargs)


def differential_evolution(*args, **kwargs):
    """Genetic search over bounded ranges (reference:
    ``experiment.differential_evolution``, evolutionary_search_mnist.ipynb:267)."""
    from hops_tpu_torch.search.drivers import differential_evolution as _de

    return _de(*args, **kwargs)


def lagom(*args, **kwargs):
    """Async parallel-trial driver (reference: ``maggy.experiment.lagom``,
    SURVEY.md §2.4)."""
    from hops_tpu_torch.search.drivers import lagom as _lagom

    return _lagom(*args, **kwargs)
