"""ext_obs_roofline (%): the bytes bound of the observables kernel
(``csrc/ext_obs_diagonals.cu``, found in the device trace by its name) over
its device time in the traced evolution.  The bound counts every limb byte
read once and every sum written once for the columns of one evolution
(``counts.ext_obs_bytes``), over the card's HBM rate.  Above 100% the count
or the time is wrong: it is reported as it is, never clipped."""

KERNEL = "ext_obs_kernel"


def read(ctx):
    trace, peaks = ctx["trace"], ctx["peaks"]
    if trace is None or peaks is None or ctx["route"] != "ext":
        return None
    seconds = sum(v["seconds"] for k, v in trace["kernels"].items() if KERNEL in k)
    if seconds <= 0.0:
        return None
    c = ctx["counts"]
    nbytes = c.ext_obs_bytes(ctx["dim"], c.ext_obs_columns(ctx["steps"]))
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
