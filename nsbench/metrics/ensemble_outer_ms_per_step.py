"""Milliseconds per batch step that the batched pressure solve
(``sor.solve_pressure_batch``) spends outside its inner stage: each outer
pass's f64 masters, defects, norms and go-on flags of every member (the
plain pass of a batch, ~28 launches), the host read of the flags and the
launches between.  It is the host wall time of the ``pressure_batch``
spans less that of the ``sor_inner`` spans inside them, per step.

Host walls alone, as ``masked_outer_ms_per_step`` reads: the profiler's
alignment of the device clock can move a span's last kernel end by
milliseconds, and each pass ends at the host's read of its flags, a sync,
so the batched solve's host end is after the kernels of its inner
stages."""


def read(s):
    outer = s["spans"].get("pressure_batch")
    inner = [span for span in s["spans"].get("sor_inner", ())
             if "pressure_batch" in span["within"]]
    if not outer or not inner or not s["steps"]:
        return None
    total = sum(span["end"] - span["start"] for span in outer)
    inside = sum(span["end"] - span["start"] for span in inner)
    return (total - inside) / s["steps"] * 1e3
