"""Run one cell of the benchmark once and print its result line.

    python3 -m nsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the numbers compared with their limits); the last lines
of standard error repeat those numbers.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 and prints no result; if JAX, a
JAX library or the JAX package was loaded, it exits 3 and prints no result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# Build caches of Triton, torch extensions and the CUDA driver's JIT, at
# fixed paths inside the checkout, so that only a cell's first run there
# builds: the port builds its own kernels into build/torch_kernels/, and a
# later kernel of another kind finds its cache set here.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for name, sub in CACHES.items():
        os.environ[name] = str(CHECKOUT / "build" / "nsbench_cache" / sub)

    from nsbench.registry import Registry

    registry = Registry()
    chips = registry.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nsbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from nsbench.harness import ForbiddenImport, run_cell

    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", registry, START)
    except ForbiddenImport as err:
        print(f"nsbench: {err}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
