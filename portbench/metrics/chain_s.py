"""chain_s: seconds per evolution in the step-operator chain, the port's
StageTimer stages ``horner``, ``squarings`` and ``doubling``."""

STAGES = ("horner", "squarings", "doubling")


def read(ctx):
    st = ctx["stages"]
    if not all(s in st for s in STAGES):
        return None
    return sum(st[s] for s in STAGES) / ctx["n_evolutions"]
