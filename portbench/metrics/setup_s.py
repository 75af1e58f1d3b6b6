"""setup_s: process start to the first timed evolution (host clock):
imports, the card's start, building or loading the kernels, and the warm-up
evolution at this cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
