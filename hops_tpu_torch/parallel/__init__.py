"""Distribution layer (counterpart of ``hops_tpu/parallel``): meshes of
ranks, DTensor placements, and the data-parallel strategies on DDP and
FSDP2, over the process group that :mod:`~hops_tpu_torch.parallel.multihost`
joins. Gradient communication (``grad_comms``), tensor, sequence and
pipeline parallelism are later slices.
"""

from hops_tpu_torch.parallel import mesh, multihost, sharding, strategy  # noqa: F401
from hops_tpu_torch.parallel.strategy import (  # noqa: F401
    CollectiveAllReduceStrategy,
    MirroredStrategy,
    ParameterServerStrategy,
    ShardedStrategy,
    Strategy,
    current_strategy,
    get_strategy,
)
