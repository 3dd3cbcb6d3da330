"""Milliseconds per time step that the masked pressure solve spends
outside its V-cycles: the f64 master, the defect, the norm and the host
sync of each outer pass and the launches between them.  It is the host
wall time of the pressure span less that of each outermost
``masked_vcycle`` span inside it, per step.

Host walls alone: the profiler's alignment of the device clock can move
a span's last kernel end by milliseconds (one traced run of this cell on
an H100 read 0.49 ms/step with kernel ends counted, against 11-13 ms/step
of idle time in the pressure span outside the cycles), and each pass ends
at the host's read of its norm, a sync, so the pressure span's host end
is after the kernels of its cycles."""


def read(s):
    pressure = s["spans"].get("pressure")
    cycles = [span for span in s["spans"].get("masked_vcycle", ())
              if "pressure" in span["within"]
              and "masked_vcycle" not in span["within"]]
    if not pressure or not cycles or not s["steps"]:
        return None
    total = sum(span["end"] - span["start"] for span in pressure)
    inner = sum(span["end"] - span["start"] for span in cycles)
    return (total - inner) / s["steps"] * 1e3
