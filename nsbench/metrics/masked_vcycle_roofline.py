"""The masked V-cycle's share of its roofline: the least time one masked
V(2,2) cycle on the grid could take at the card's peaks
(work/masked_vcycle.py), whatever implements it, over the device time of
the kernels under the outermost ``masked_vcycle`` spans."""


def read(s):
    spans = [span for span in s["spans"].get("masked_vcycle", ())
             if "masked_vcycle" not in span["within"]]
    kernel_s = sum(span["kernel_s"] for span in spans)
    bounds = [s["bound"]("masked_vcycle", span["args"]) for span in spans]
    if not spans or kernel_s <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / kernel_s
