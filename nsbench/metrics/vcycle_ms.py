"""Milliseconds per V-cycle of the multigrid inner stage: its span's wall
time, until the last kernel it launched has ended, over the cycles it
ran."""


def read(s):
    spans = s["spans"].get("mg_inner")
    if not spans:
        return None
    cycles = sum(span["args"]["n"] for span in spans)
    wall = sum(max(span["end"], span["device_end"] or 0.0) - span["start"]
               for span in spans)
    return wall / cycles * 1e3 if cycles else None
