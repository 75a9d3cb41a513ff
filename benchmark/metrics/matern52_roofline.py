"""The Matern-5/2 tile's share of its roofline, in %: ``matern52_bound_ms``
at the predictor's launch shape over the device time per launch of the
kernel library's two kernels (the pre-pass ``transpose_norms_kernel`` and
``matern52_tile_kernel``), found by name in the profiled sub-window's
device timeline."""

from benchmark import roofline

KERNELS = ("transpose_norms_kernel", "matern52_tile_kernel")


def read(record):
    profile, shapes = record.get("profile"), record.get("shapes")
    if not profile or not shapes:
        return None
    seconds, launches = 0.0, 0
    for name, (total, count) in profile["ops"].items():
        if KERNELS[0] in name:
            seconds += total
        elif KERNELS[1] in name:
            seconds += total
            launches += count
    if not launches:
        return None
    bound_ms, _ = roofline.matern52_bound_ms(shapes["queries"], shapes["landmarks"],
                                             shapes["dims"], "float32")
    return 100.0 * bound_ms / (1e3 * seconds / launches)
