"""Host milliseconds per predictor call inside the program, up to the
return of the enqueued work (the program's ``predictor.mean`` spans of
the profiled calls, over their number)."""

from benchmark.program_record import milliseconds, per, span_sum


def read(record):
    return per(record, "predictor.mean", lambda p: milliseconds(
        span_sum(p, ("predictor.mean",), "host_s")))
