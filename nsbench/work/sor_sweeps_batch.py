"""Operations and bytes of one call of the SOR inner stage on a batch:
``sor_sweeps.py``'s count for each member of a leading member axis (every
member takes the call's n sweeps).  `args` holds the call's ``shape``
(members first) and ``n``.
"""

import math

from nsbench.work import sor_sweeps


def count(args):
    flops, nbytes = sor_sweeps.count(args)
    members = math.prod(args["shape"][:-2])
    return flops * members, nbytes * members
