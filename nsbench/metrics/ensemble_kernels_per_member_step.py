"""Device kernels launched per member step over the profiled solves: the
traced solves' kernels over their batch steps times the members each
step carries, the leading axis of u that each ``ensemble_step`` span
recorded (a member held at T counts: the batch step computes it)."""


def read(s):
    spans = s["spans"].get("ensemble_step")
    if not spans or not s["n_kernels"]:
        return None
    shapes = [span["args"].get("shape") for span in spans]
    if None in shapes:
        return None
    return s["n_kernels"] / sum(shape[0] for shape in shapes)
