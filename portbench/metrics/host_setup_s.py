"""host_setup_s: seconds per evolution in the port's StageTimer stages
``setup`` and ``split``: the host operator, energy and spectral-norm bound,
and the limb split of the step operator's generator."""


def read(ctx):
    st, n = ctx["stages"], ctx["n_evolutions"]
    if "setup" not in st or "split" not in st:
        return None
    return (st["setup"] + st["split"]) / n
