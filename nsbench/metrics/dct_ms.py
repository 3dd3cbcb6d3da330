"""Milliseconds per DCT solve of the fft inner stage: its span's wall
time, until the last kernel it launched has ended, over the solves it
ran."""


def read(s):
    spans = s["spans"].get("fft_inner")
    if not spans:
        return None
    solves = sum(span["args"]["n"] for span in spans)
    wall = sum(max(span["end"], span["device_end"] or 0.0) - span["start"]
               for span in spans)
    return wall / solves * 1e3 if solves else None
