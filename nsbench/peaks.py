"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3.  A card set below
700 W reaches less; the run's line carries the power limit beside them.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def bound_seconds(peaks, flops, n_bytes):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory peak."""
    return max(flops / peaks["f32_flops"], n_bytes / peaks["bytes_per_s"])
