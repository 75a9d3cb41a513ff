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

A cell whose ``chips`` is 1 runs in this process, on ``cuda``.  A cell
whose ``chips`` is N > 1 runs as N rank processes in one NCCL process
group, rank r on ``cuda:<r>`` (``harness.run``, ``rank.py``), and this
process prints rank 0's line as the one result line.  Its ``device``
reports ``count``, the distinct devices the ranks ran on, the fullest
device's memory peak, and ``per_device``, each rank's index, peak and
(traced) busy and window seconds; where ``count`` is below N, or a rank
holds JAX or the JAX package, no line is printed and the run exits with
2.  A rank that fails ends the run: the others are killed, and the run
exits with the failed rank's code.
"""

import argparse
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
    chips = int(harness.find(spec["workloads"], args.workload, "cell")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s), "
              f"{'one rank process on each' if chips > 1 else 'in this process'}; "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    code, result = harness.run(args.workload, args.seed, args.seconds, args.trace, spec=spec,
                               t_start=T_START)
    return harness.emit(result, chips) if result is not None else code


if __name__ == "__main__":
    sys.exit(main())
