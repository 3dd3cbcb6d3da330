"""The batched SOR inner stage's share of its roofline: the least time the
sweeps of every member could take at the card's peaks
(work/sor_sweeps_batch.py) over the device time of every kernel launched
under the inner-stage spans inside the batched pressure solve
(``pressure_batch``), where one launch sweeps all members."""


def read(s):
    spans = [span for span in s["spans"].get("sor_inner", ())
             if "pressure_batch" in span["within"]]
    if not spans:
        return None
    kernel_s = sum(span["kernel_s"] for span in spans)
    bounds = [s["bound"]("sor_sweeps_batch", span["args"]) for span in spans]
    if kernel_s <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / kernel_s
