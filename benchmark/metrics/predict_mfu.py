"""The whole predictor call's share of the H100's roofline, in %: the
least time a call could take (``roofline.predict_work``: the Matern-5/2
tile's operations plus the product with the weights, or the queries,
landmarks, weights and outputs moved once) over the measured seconds per
call (the benchmark's spans around the calls outside the profiled ones,
each ending at a synchronise)."""

from benchmark import roofline


def read(record):
    spans, shapes = record["spans"].get("predict.call"), record.get("shapes")
    if not spans or not shapes:
        return None
    bound = roofline.bound_seconds(
        *roofline.predict_work(shapes["queries"], shapes["landmarks"], shapes["dims"]))
    return 100.0 * bound / (sum(spans) / len(spans))
