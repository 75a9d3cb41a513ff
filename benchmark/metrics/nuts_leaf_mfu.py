"""The whole lockstep leaf's share of the H100's roofline, in %: the
least time one leaf of every chain could take (``roofline.nuts_leaf_work``
at the cell's shapes: every operand read once at the memory rate, or its
operations at the float32 peak, whichever is longer) over the measured
time per leaf (the benchmark's spans around the window's ``resume_mcmc``
blocks outside the profiled one, over their lockstep leaves)."""

from benchmark import roofline


def read(record):
    spans, leaves = record["spans"].get("nuts.block"), record["counters"].get("leaves")
    shapes = record.get("shapes")
    if not spans or not leaves or not shapes:
        return None
    bound = roofline.bound_seconds(
        *roofline.nuts_leaf_work(shapes["cells"], shapes["latents"], shapes["chains"]))
    return 100.0 * bound / (sum(spans) / leaves)
