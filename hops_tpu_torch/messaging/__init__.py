"""Host-side messaging (counterpart of ``hops_tpu/messaging``). Only the
run search index is ported so far."""
