"""The readings that a cell's limits are set from, on the card: the
program's over many seeds, and the precision control's.

    python3 -m nsbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out chiprun_out/<file>.jsonl]

Every step goes through the family that the cell's configuration names
(``families/<name>.py``).  For each seed of ``--seeds`` it runs one solve
of the timed path (the harness's own ``Solves.run``: ``solver.run_steps``
over the family's stepper from its seeded state, after its ``warm_up``)
and compares the family's fields with the reference's by the family's
readings.  For each seed of ``--control-seeds`` it puts the control in the
program's place: the family's reference with every field the
configuration keeps in float32 (for the cavity u, v, F, G, rhs, p) rounded
to bfloat16, the precision below float32, and reads the fields of its
result against the reference in the same way.  One JSON line per reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .harness import Cell, Solves
from .registry import Registry


def bfloat16_store(x: torch.Tensor) -> torch.Tensor:
    """A field kept in bfloat16 (and computed on in float64)."""
    return x.to(torch.bfloat16).to(torch.float64)


def control_readings(cell: Cell, seed: int, device) -> dict:
    state = cell.initial_state(seed, device)
    ref = cell.reference(state)
    ctl = cell.reference(state, store=bfloat16_store)
    return cell.family.readings(cell.family.fields(ctl), ctl.steps, ref,
                                cell)


def program_readings(cell: Cell, seed: int, device) -> dict:
    state = cell.initial_state(seed, device)
    out, steps = Solves(cell, state).run()
    kept = {name: x.to(torch.float64)
            for name, x in cell.family.fields(out).items()}
    del out
    ref = cell.reference(state)
    return cell.family.readings(kept, steps, ref, cell)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    cell = Cell(Registry(), args.workload)
    device = torch.device("cuda")
    cell.family.warm_up(cell, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    runs = [("program", s) for s in args.seeds.split(",") if s] + [
        ("control", s) for s in args.control_seeds.split(",") if s]
    for kind, seed in runs:
        t0 = time.perf_counter()
        fn = program_readings if kind == "program" else control_readings
        readings = fn(cell, int(seed), device)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": int(seed), "readings": readings,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
