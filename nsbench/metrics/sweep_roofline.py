"""The SOR inner stage's share of its roofline: the least time its sweeps
could take at the card's peaks (work/sor_sweeps.py) over the device time of
every kernel launched under its span."""


def read(s):
    spans = s["spans"].get("sor_inner")
    if not spans:
        return None
    kernel_s = sum(span["kernel_s"] for span in spans)
    bounds = [s["bound"]("sor_sweeps", span["args"]) for span in spans]
    if kernel_s <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / kernel_s
