"""Seconds from process start to the first timed query: imports, the CUDA
context, the data made on the device, the index build, the spill and its
flush where the configuration has one, kernel loads and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
