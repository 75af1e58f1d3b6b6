"""evolution_s: the window's wall time over the evolutions it completed
(host clock; the evolution in flight when the window's seconds ran out
completed and counts)."""


def read(ctx):
    return ctx["window_s"] / ctx["n_evolutions"] if ctx["n_evolutions"] else None
