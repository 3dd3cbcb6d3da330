"""Device kernels launched per masked V-cycle: the kernels under the
outermost ``masked_vcycle`` spans over their count."""


def read(s):
    spans = [span for span in s["spans"].get("masked_vcycle", ())
             if "masked_vcycle" not in span["within"]]
    kernels = sum(span["n_kernels"] for span in spans)
    if not spans or not kernels:
        return None
    return kernels / len(spans)
