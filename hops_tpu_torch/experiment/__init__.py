"""Experiment layer — launchers, registry, tensorboard (counterpart of
``hops_tpu/experiment``).

``launch`` runs a wrapper function holding a whole training program in
a run directory of its own and registers the run; ``mirrored``,
``collective_all_reduce`` and ``parameter_server`` run it inside a
data-parallel strategy's scope in every process of the run. The
hyperparameter search launchers are not ported yet.
"""

from hops_tpu_torch.experiment import registry, tensorboard  # noqa: F401
from hops_tpu_torch.experiment.core import (  # noqa: F401
    collective_all_reduce,
    launch,
    mirrored,
    parameter_server,
)
