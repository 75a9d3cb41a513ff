"""Host milliseconds per lockstep leaf blocked in the leaf loop's read
of the active mask (the program's ``nuts.host_read`` spans, one per
read) over the ``nuts.leaf`` spans of the profiled block."""

from benchmark.program_record import milliseconds, per, span_sum


def read(record):
    return per(record, "nuts.leaf", lambda p: milliseconds(
        span_sum(p, ("nuts.host_read",), "host_s")))
