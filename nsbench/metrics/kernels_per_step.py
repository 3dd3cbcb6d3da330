"""Device kernels launched per time step over the profiled solves."""


def read(s):
    if not s["steps"] or not s["n_kernels"]:
        return None
    return s["n_kernels"] / s["steps"]
