"""The program's own spans and counters for the per-layer readers.

``mellon_tpu_torch.utils.profiling`` records the program's spans and
counters while a ``torch.profiler`` session records, so a traced run's
profiled sub-window (``Context.profiled``: one fit, one NUTS block, the
profiled predictor calls) leaves its record in the program.  The first
reader takes it, once, into ``record["program"]`` (``profiling.take()``:
``{"spans": [{"name", "parent", "host_s", "device_s", "self_s", ...}],
"counters": {...}}``); a program without that record gives None there,
and every reader then None."""


def program(record):
    """The program's record of the profiled sub-window, or None."""
    if "program" not in record:
        try:
            from mellon_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        take = getattr(profiling, "take", None)
        record["program"] = take() if take is not None else None
    return record["program"]


def per(record, unit, total):
    """``total(program record)`` over the number of the program's ``unit``
    spans (fits, leaves, calls); None without a record, without such a
    span, or where ``total`` gives None."""
    prog = program(record)
    if not prog:
        return None
    n = sum(s["name"] == unit for s in prog["spans"])
    value = total(prog) if n else None
    return None if value is None else value / n


def device_total(prog, names):
    """The device seconds of the spans named in ``names``: for each name
    the mean over its spans that were timed (the program times one of a
    name's device spans per 20 ms) times their number; None where a name
    has spans and none was timed (as on the CPU)."""
    total = 0.0
    for name in names:
        values = [s["device_s"] for s in prog["spans"] if s["name"] == name]
        timed = [v for v in values if v is not None]
        if values and not timed:
            return None
        total += sum(timed) / len(timed) * len(values) if timed else 0.0
    return total


def span_sum(prog, names, key):
    """The sum of ``key`` (``host_s`` or ``self_s``) over the spans named
    in ``names``."""
    return sum(s[key] for s in prog["spans"] if s["name"] in names)


def milliseconds(seconds):
    return None if seconds is None else 1e3 * seconds
