"""Host-side messaging (counterpart of ``hops_tpu/messaging``): the run
search index, the pubsub topics that serving tees its inference log
onto, and the JSON-line RPC that carries the search driver's heartbeats.
``tls`` is not ported yet."""
