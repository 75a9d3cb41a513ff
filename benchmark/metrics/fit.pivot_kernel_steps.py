"""Pivot steps per fit that the hand-written step kernel ran (the
program's ``pivot.kernel_steps`` counter: stage 1's steps inside its
captured graph and the host-checked selection's, launched or replayed);
None where the program keeps no such counter (one without the kernel)."""

from benchmark.program_record import per


def read(record):
    return per(record, "prepare", lambda p: p["counters"].get("pivot.kernel_steps"))
