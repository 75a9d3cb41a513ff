"""Device milliseconds per fit of the fused prepare's two stages: the
program's ``prepare.stage1`` and ``prepare.stage2`` spans (a CUDA event
on the stage's stream at each end of its graph replay, capture or eager
run) over the profiled fit's ``prepare`` spans.  None without device
times (on the CPU)."""

from benchmark.program_record import device_total, milliseconds, per


def read(record):
    return per(record, "prepare", lambda p: milliseconds(
        device_total(p, ("prepare.stage1", "prepare.stage2"))))
