"""Pivot steps per fit that the host-checked pivot loop ran (the
program's ``pivot.steps`` counter: each chunk's steps, up to the chunk
in which the stopping rule fell); 0 where the profiled fit ran none."""

from benchmark.program_record import per


def read(record):
    return per(record, "prepare", lambda p: p["counters"].get("pivot.steps", 0))
