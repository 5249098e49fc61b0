"""Engine: milliseconds each request admitted in the window waited in
the engine's queue, from its ``submit`` (or its requeue after a
preemption) to its admission (``LMEngine.stats()`` ``queue_wait_s`` over
the engine's own count of admissions, ``admitted``). None where the
program keeps no such count."""


def read(cell, out):
    s0, s1 = out.layer.get("stats0"), out.layer.get("stats1")
    if s0 is None or s1 is None or "admitted" not in s0 or "admitted" not in s1:
        return None
    n = s1["admitted"] - s0["admitted"]
    return 1e3 * (s1["queue_wait_s"] - s0["queue_wait_s"]) / n if n > 0 else None
