"""model_build_s: seconds per evolution in the port's StageTimer stage
``build_model`` (``simulate_rare``'s model build: geometry, couplings, the
operator sum and the initial state).  None where the program has no such
stage."""


def read(ctx):
    st = ctx["stages"]
    if "build_model" not in st or not ctx["n_evolutions"]:
        return None
    return st["build_model"] / ctx["n_evolutions"]
