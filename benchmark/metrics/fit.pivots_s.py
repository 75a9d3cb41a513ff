"""Host seconds per fit in the doubling pivot selection
(``ops.linalg.select_stable_landmarks``, the program's
``prepare.pivots`` span), which runs where stage 1's in-graph pivots hit
their cap; 0 where the profiled fit ran none."""

from benchmark.program_record import per, span_sum


def read(record):
    return per(record, "prepare", lambda p: span_sum(p, ("prepare.pivots",), "host_s"))
