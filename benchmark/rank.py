"""One rank of a cell that runs on several devices, started by
``harness.run_ranks`` (from ``run.py`` or ``control.py``), not by hand:

    python3 benchmark/rank.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        --rank <r> --world <N> --device cuda:<r> --backend nccl --store <file>
        --t0 <launch's start, epoch seconds> [--parent <pid>] [--control] [--fault <name>]

It joins the process group (a ``FileStore`` at ``--store``), runs the
cell on its device (``harness.rank_main``), and on rank 0 prints the
result line.  It is killed when its launcher (``--parent``) dies."""

import ctypes
import os
import signal
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PR_SET_PDEATHSIG = 1


def main(argv):
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if "--parent" in argv and os.getppid() != int(argv[argv.index("--parent") + 1]):
        return 1  # the launcher died before the signal was armed
    from benchmark import harness

    return harness.rank_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
