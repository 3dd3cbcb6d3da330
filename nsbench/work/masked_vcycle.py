"""Operations and bytes of one masked V(2,2) cycle on a padded float32
grid, whatever implements it.

The levels are the masked multigrid's: the interior halves while both
sides are even and the halves keep at least 8 cells, the last level takes
32 smoothing sweeps, every other one 2 before and 2 after its coarse
correction.  Each sweep updates every interior cell once, at 11 float32
operations (7 in the weighted neighbour sum, 4 in the relaxation; an FMA
counts two); the residual is 10 a cell, the restriction 4 a coarse cell
(3 adds, 1 scaling) and the prolongation 1 a fine cell.  Every interior
cell is counted, solid or fluid: the cylinder holds under 1 % of them.

Each array is read once and written once a cycle: level 0's rhs read and
its correction written, and on every level the open-face couplings to the
east and the north neighbours (the west and south ones are the
neighbours'), from which the diagonal follows.  The coarse levels' rhs
and corrections are counted neither way: a fused cycle keeps them on chip.
`args` holds the call's padded ``shape``.
"""

SWEEP = 11
RESIDUAL = 10
RESTRICT = 4
PROLONG = 1
PRE_POST = 4
COARSE_SWEEPS = 32
MIN_CELLS = 8
BYTES_PER_VALUE = 4


def levels(rows, cols):
    """The interior (ni, nj) of each level, finest first."""
    ni, nj = rows - 2, cols - 2
    out = [(ni, nj)]
    while not (ni % 2 or nj % 2 or ni // 2 < MIN_CELLS
               or nj // 2 < MIN_CELLS):
        ni, nj = ni // 2, nj // 2
        out.append((ni, nj))
    return out


def count(args):
    sizes = [ni * nj for ni, nj in levels(*args["shape"][-2:])]
    flops = COARSE_SWEEPS * SWEEP * sizes[-1]
    for fine, coarse in zip(sizes, sizes[1:]):
        flops += ((PRE_POST * SWEEP + RESIDUAL + PROLONG) * fine
                  + RESTRICT * coarse)
    n_bytes = BYTES_PER_VALUE * (2 * sizes[0] + 2 * sum(sizes))
    return flops, n_bytes
