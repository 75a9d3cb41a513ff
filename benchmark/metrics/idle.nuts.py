"""The device's idle share during NUTS blocks, in %: the share of the
profiled sub-window in which no kernel, copy or fill ran, from
``torch.profiler``'s device timeline."""


def read(record):
    profile = record.get("profile")
    if not profile or not profile["window_s"]:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
