"""Engine: milliseconds of the admission calls' host launch time, up to
the first-token read-back, per request admitted in the window
(``LMEngine.stats()`` ``prefill_launch_s`` over ``admitted``). The rest
of ``prefill_s`` is the wait for the card and the host's bookkeeping.
None where the program keeps no such count."""


def read(cell, out):
    s0, s1 = out.layer.get("stats0"), out.layer.get("stats1")
    if s0 is None or s1 is None or "admitted" not in s0 or "admitted" not in s1:
        return None
    n = s1["admitted"] - s0["admitted"]
    return 1e3 * (s1["prefill_launch_s"] - s0["prefill_launch_s"]) / n if n > 0 else None
