"""The NUTS leaf loop's host reads per lockstep leaf: the sum of
``MCMCResult.host_reads`` over the window's blocks outside the profiled
one, over their lockstep leaves (``num_evaluations`` / chains)."""


def read(record):
    c = record["counters"]
    return c["host_reads"] / c["leaves"] if c.get("leaves") else None
