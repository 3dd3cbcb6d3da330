"""Milliseconds per masked V-cycle: the wall time of each outermost
``masked_vcycle`` span (a cycle's recursion opens one span a level), until
the last kernel launched under it has ended, over their count."""


def read(s):
    spans = [span for span in s["spans"].get("masked_vcycle", ())
             if "masked_vcycle" not in span["within"]]
    if not spans:
        return None
    wall = sum(max(span["end"], span["device_end"] or 0.0) - span["start"]
               for span in spans)
    return wall / len(spans) * 1e3
