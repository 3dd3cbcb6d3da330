"""Operations and bytes of one call of the SOR inner stage: n red-black
sweeps of A delta = rhs from delta = 0 on a padded float32 grid.

Each sweep updates every interior cell once, at 11 float32 operations (7
in the neighbour sum, 4 in the relaxation; an FMA counts two).  The call
reads rhs once and writes delta once.  `args` holds the call's padded
``shape`` and ``n``.
"""

FLOPS_PER_CELL_UPDATE = 11
BYTES_PER_VALUE = 4


def count(args):
    rows, cols = args["shape"][-2:]
    cells = (rows - 2) * (cols - 2)
    flops = FLOPS_PER_CELL_UPDATE * cells * args["n"]
    return flops, 2 * BYTES_PER_VALUE * rows * cols
