"""Distribution layer (counterpart of ``hops_tpu/parallel``). Only the
process-index helpers of :mod:`~hops_tpu_torch.parallel.multihost` are
ported so far; meshes, strategies and gradient communication are a
later slice."""
