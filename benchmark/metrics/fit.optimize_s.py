"""Seconds of the estimator's ``run_inference`` per fit (L-BFGS over the
density loss), from the benchmark's span around the instance's method,
ending at a synchronise; the mean over the window's fits outside the
profiled one."""


def read(record):
    spans = record["spans"].get("fit.optimize")
    return sum(spans) / len(spans) if spans else None
