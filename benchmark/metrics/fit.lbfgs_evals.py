"""L-BFGS loss evaluations per fit (the program's ``lbfgs.evaluations``
counter, added at the end of each run of ``optimizers._lbfgs``)."""

from benchmark.program_record import per


def read(record):
    return per(record, "prepare", lambda p: p["counters"].get("lbfgs.evaluations", 0))
