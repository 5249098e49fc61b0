"""Engine: microseconds per decode token of the decode dispatches' host
launch time, from the dispatch's start to the return of its last
launch, nothing read back (``LMEngine.stats()`` ``decode_launch_s`` over
``decode_tokens``). None where the program keeps no such clock."""


def read(cell, out):
    s0, s1 = out.layer.get("stats0"), out.layer.get("stats1")
    if s0 is None or s1 is None or "decode_launch_s" not in s0 or "decode_launch_s" not in s1:
        return None
    n = s1["decode_tokens"] - s0["decode_tokens"]
    return 1e6 * (s1["decode_launch_s"] - s0["decode_launch_s"]) / n if n > 0 else None
