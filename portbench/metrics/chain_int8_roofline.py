"""chain_int8_roofline (%): the least time of the chain's int8 GEMM work
(its operations, counted by ``counts.chain_ops`` from the stages' calls,
over the card's dense int8 rate) over the chain's stage time.  Above 100%
the count or the time is wrong: it is reported as it is, never clipped."""

STAGES = ("horner", "squarings", "doubling")


def read(ctx):
    st, peaks = ctx["stages"], ctx["peaks"]
    if peaks is None or not all(s in st for s in STAGES):
        return None
    ops = ctx["counts"].chain_ops(ctx["route"], ctx["dim"], ctx["calls"], ctx["n_evolutions"])
    if ops is None:
        return None
    return 100.0 * ops / peaks["int8_ops_per_s"] / sum(st[s] for s in STAGES)
