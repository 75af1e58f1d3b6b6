"""evolution_mfu (%): the int8 GEMM operations of a whole evolution (the
chain, ``counts.chain_ops``, and the block advances,
``counts.advance_ops``) over the card's dense int8 rate, as a share of the
traced run's mean evolution wall.  It bounds what the kernels' rooflines
can claim together."""


def read(ctx):
    peaks, n = ctx["peaks"], ctx["n_evolutions"]
    if peaks is None or not n:
        return None
    c = ctx["counts"]
    chain = c.chain_ops(ctx["route"], ctx["dim"], ctx["calls"], n)
    adv = c.advance_ops(ctx["route"], ctx["dim"], ctx["steps"])
    if chain is None or adv is None:
        return None
    wall = sum(ctx["evolution_walls"]) / n
    return 100.0 * (chain / n + adv) / peaks["int8_ops_per_s"] / wall
