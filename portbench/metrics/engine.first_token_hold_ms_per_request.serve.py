"""Engine: milliseconds from a request's first token reaching the host
to the end of the ``step()`` that brought it (the harness stamps the
first token there), per request admitted in the window
(``LMEngine.stats()`` ``first_token_hold_s`` over ``admitted``). None
where the program keeps no such count."""


def read(cell, out):
    s0, s1 = out.layer.get("stats0"), out.layer.get("stats1")
    if s0 is None or s1 is None or "admitted" not in s0 or "admitted" not in s1:
        return None
    n = s1["admitted"] - s0["admitted"]
    return 1e3 * (s1["first_token_hold_s"] - s0["first_token_hold_s"]) / n if n > 0 else None
