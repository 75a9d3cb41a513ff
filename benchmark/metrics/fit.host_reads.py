"""Deliberate device-to-host reads per fit (the program's ``host_reads``
counter): the fused prepare's one read, the pivot loop's chunk reads,
L-BFGS's one per loss evaluation and the optimistic factor's reads."""

from benchmark.program_record import per


def read(record):
    return per(record, "prepare", lambda p: p["counters"].get("host_reads", 0))
