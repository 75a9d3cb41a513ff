"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name from ``BENCHMARK.json``
(``benchmark/harness.py``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines of standard error repeat the
checks.  Exits with 2, and prints no result, without enough CUDA devices,
or where the process holds JAX or the JAX package once the window has
closed.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths, so
# that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "cell")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace, "cuda",
                              spec=spec, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window", file=sys.stderr)
        return 2
    for name, held in result["checks"].items():
        print(f"check {name} {held['value']!r} limit {held['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
