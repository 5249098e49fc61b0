"""Host-side messaging (counterpart of ``hops_tpu/messaging``): the run
search index and the pubsub topics that serving tees its inference log
onto. ``rpc`` and ``tls`` are not ported yet."""
