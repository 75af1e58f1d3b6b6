"""advance_obs_s: seconds per evolution in the block advance and the
observables, the port's StageTimer stages ``advance`` and ``obs`` (the Ozaki
route takes its observables inside ``advance``)."""


def read(ctx):
    st = ctx["stages"]
    if "advance" not in st:
        return None
    return (st["advance"] + st.get("obs", 0.0)) / ctx["n_evolutions"]
