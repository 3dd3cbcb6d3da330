"""The share of the profiled solves' wall time in which no kernel, copy or
fill ran on the device."""


def read(s):
    if not s["window_s"] or not s["n_kernels"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
