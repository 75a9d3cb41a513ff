"""Host milliseconds per lockstep leaf in the NUTS leaf's own work, the
tree bookkeeping: the self time of the program's ``nuts.leaf`` spans
(the leaf less its ``nuts.potential`` call) over their number, in the
profiled block."""

from benchmark.program_record import milliseconds, per, span_sum


def read(record):
    return per(record, "nuts.leaf", lambda p: milliseconds(span_sum(p, ("nuts.leaf",), "self_s")))
