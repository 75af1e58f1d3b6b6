"""device_idle_share (%): the share of the traced evolution in which no
kernel, copy or fill ran on the card, from the profiler's timeline."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0.0 or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
