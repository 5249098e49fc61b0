"""Engine: microseconds per decode token of the decode dispatches
outside their launch and read-back, the host's row-by-row replay of the
tokens read back (``LMEngine.stats()`` ``decode_s`` less
``decode_launch_s`` and ``decode_readback_s``, over ``decode_tokens``).
None where the program keeps no such clock."""

KEYS = ("decode_s", "decode_launch_s", "decode_readback_s")


def read(cell, out):
    s0, s1 = out.layer.get("stats0"), out.layer.get("stats1")
    if s0 is None or s1 is None or any(k not in s0 or k not in s1 for k in KEYS):
        return None
    n = s1["decode_tokens"] - s0["decode_tokens"]
    if n <= 0:
        return None
    own = [s1[k] - s0[k] for k in KEYS]
    return 1e6 * (own[0] - own[1] - own[2]) / n
