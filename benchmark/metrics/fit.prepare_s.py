"""Seconds of the estimator's ``prepare_inference`` per fit (the fused
prepare and the lazy chain below it), from the benchmark's span around
the instance's method, ending at a synchronise; the mean over the
window's fits outside the profiled one."""


def read(record):
    spans = record["spans"].get("fit.prepare")
    return sum(spans) / len(spans) if spans else None
