"""The control of a cell's comparison, and the faults planted on the
chip.  The benchmark's own runs do neither.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> ... --fault <name>

For each seed one run of the cell (``harness.run_cell``: its set-up, a
window of ``--seconds`` at the cell's load, the comparison), and one
JSON line with the program's verdict and numbers beside the limits.
Without ``--fault`` the line also holds the control's (``control``): the
plain reference computed at the precision below the configuration's
(float32 with every product's operands rounded to TF32:
``reference.density.CONTROL``), put in the program's place and judged by
the same check; it has to come out as not correct.  With ``--fault`` the
fault of that name in ``benchmark/faults.py`` is planted in the program
first, and the program's verdict has to be false.  The cell runs as its
``chips`` ask (``harness.run``: on several devices as its ranks, each
with the fault planted); a seed whose run fails prints its exit code
instead."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", help="a fault of benchmark/faults.py to plant")
    args = parser.parse_args(argv)

    from benchmark import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        code, result = harness.run(args.workload, seed, args.seconds, 0, control=not args.fault,
                                   fault=args.fault)
        if result is None:
            print(json.dumps({"seed": seed, "fault": args.fault, "exit": code,
                              "seconds": time.perf_counter() - t0}), flush=True)
            continue
        line = {"seed": seed, "fault": args.fault, "correct": result["correct"],
                "checks": result["checks"], "metrics": result["metrics"],
                "seconds": time.perf_counter() - t0}
        if "control" in result:
            line["control"] = result["control"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
