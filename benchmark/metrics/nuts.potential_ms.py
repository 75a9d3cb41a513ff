"""Device milliseconds per lockstep leaf of the leaf's batched potential
call (the program's ``nuts.potential`` span around the leapfrog step: a
CUDA event at each end, so the device's idle time inside the span
counts; the mean of the timed spans, one per 20 ms) over the
``nuts.leaf`` spans of the profiled block.  None without device times
(on the CPU)."""

from benchmark.program_record import device_total, milliseconds, per


def read(record):
    return per(record, "nuts.leaf", lambda p: milliseconds(device_total(p, ("nuts.potential",))))
