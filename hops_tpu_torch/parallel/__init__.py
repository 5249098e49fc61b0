"""Distribution layer (counterpart of ``hops_tpu/parallel``): meshes of
ranks, DTensor placements, and the data-parallel strategies on DDP and
FSDP2, over the process group that :mod:`~hops_tpu_torch.parallel.multihost`
joins; explicit gradient communication (``grad_comms``: quantized,
bucketed, overlapped, hierarchical, ZeRO-1/2/3), ring/Ulysses sequence
parallelism, Megatron tensor parallelism (``tp_inference``) and pipeline
parallelism (``pipeline``, ``pp_schedule``).
"""

from hops_tpu_torch.parallel import (  # noqa: F401
    grad_comms,
    mesh,
    multihost,
    pipeline,
    pp_schedule,
    ringattention,
    sharding,
    strategy,
    tp_inference,
)
from hops_tpu_torch.parallel.grad_comms import (  # noqa: F401
    GradCommsConfig,
    all_reduce_grads,
    hier_all_gather,
    hier_reduce_scatter,
    psum_hierarchical,
    psum_quantized,
    sharded_apply_gradients,
    tag_backward_comms,
    zero2_apply_gradients,
    zero3_init,
    zero3_unshard,
)
from hops_tpu_torch.parallel.tp_inference import (  # noqa: F401
    tp_generate,
    tp_generate_speculative,
    tp_param_specs,
)
from hops_tpu_torch.parallel.strategy import (  # noqa: F401
    CollectiveAllReduceStrategy,
    MirroredStrategy,
    ParameterServerStrategy,
    ShardedStrategy,
    Strategy,
    current_strategy,
    get_strategy,
)
