"""Milliseconds per time step that the pressure solve spends outside its
inner stage: the f64 master, the defect, the norm, the host sync of each
outer pass and the launches between them.  It is the pressure span's wall
time less the wall time of each inner-stage span inside it, an inner
stage's span lasting until the last kernel it launched has ended."""


def _wall(span):
    return max(span["end"], span["device_end"] or 0.0) - span["start"]


def read(s):
    pressure = s["spans"].get("pressure")
    if not pressure or not s["steps"]:
        return None
    inner = sum(_wall(span)
                for key, layer in s["layers"].items() if layer.get("inner_stage")
                for span in s["spans"].get(key, ())
                if "pressure" in span["within"])
    total = sum(_wall(span) for span in pressure)
    return (total - inner) / s["steps"] * 1e3
