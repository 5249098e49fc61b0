"""Jobs (counterpart of ``hops_tpu/jobs``). Only the child import path
that standalone serving hosts need is ported so far
(:func:`~hops_tpu_torch.jobs.api._child_pythonpath`)."""
