"""Experiment layer — launchers, registry, tensorboard (counterpart of
``hops_tpu/experiment``).

``launch`` runs a wrapper function holding a whole training program in
a run directory of its own and registers the run. The distributed
launchers raise ``NotImplementedError`` until the distribution layer is
ported; the hyperparameter search drivers are not ported yet.
"""

from hops_tpu_torch.experiment import registry, tensorboard  # noqa: F401
from hops_tpu_torch.experiment.core import (  # noqa: F401
    collective_all_reduce,
    launch,
    mirrored,
    parameter_server,
)
