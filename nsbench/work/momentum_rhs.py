"""Operations and bytes of one call of the fused momentum pass: F, G and
rhs = div(F, G) / dt on a padded float32 grid.

122 float32 operations per interior cell (57 for F, 57 for G, 2 for the
donor-cell weights, 6 for rhs; an FMA counts two).  The call reads u and v
once and writes F, G and rhs once.  `args` holds the padded ``shape``.
"""

FLOPS_PER_CELL = 122
BYTES_PER_VALUE = 4


def count(args):
    rows, cols = args["shape"][-2:]
    flops = FLOPS_PER_CELL * (rows - 2) * (cols - 2)
    return flops, 5 * BYTES_PER_VALUE * rows * cols
