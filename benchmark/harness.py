"""The general harness: resolves a cell of ``BENCHMARK.json`` to its files
by name, runs it once and assembles the result line.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``, the one general generator of that kind of work),
and the cell's limits for ``correct`` are ``limits/<cell>.json``.  Each
per-layer metric is read by ``metrics/<metric>.py``.  A later cell,
configuration, mix or metric is added by adding files and entries.

A driver module has five functions, called in this order:

* ``setup(ctx)``: makes the inputs from the seed, builds the system and
  warms up every shape the window uses;
* ``window(ctx) -> {end-to-end metric: value}``: the measured window of
  ``ctx.seconds``; with ``ctx.trace`` it records spans and counters in
  ``ctx.record``;
* ``profile(ctx)``: with ``ctx.trace``, one more unit of the window's work
  (a fit, a block, some calls) under ``ctx.profiled()``, after the window;
* ``collect(ctx) -> outputs``: after the peak memory is read, takes what
  the timed path produced and frees the program's state;
* ``check(ctx, outputs) -> [(name, value), ...]``: the comparison with the
  plain reference (``reference/``), each number held to its limit.

``control(ctx, outputs)`` gives the control's outputs in the program's
place; only ``control.py`` asks for it (``run_cell(..., control=True)``),
the benchmark's runs never call it.

An end-to-end metric ``<quantity>.<qualifier>`` is the driver's
``<quantity>`` under a name of its own, so that cells whose spreads
differ take bounds of their own (``ess_per_s.atlas``); a per-layer
metric so split is read by ``metrics/<name>.py`` where that file exists,
else by the file of the name without its last qualifier.
"""

import contextlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
SPEC = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "mellon_tpu")
TOP_DEVICE_OPS = 10
TOP_GAPS = 10
NAME_CHARS = 160


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """The module in ``benchmark/<parts>`` (names may hold dots)."""
    path = os.path.join(BENCH, *parts)
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + "_".join(parts).replace(".", "_").replace("/", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quantity(name, known):
    """``name``, or the quantity it qualifies (the name without its last
    ``.<qualifier>``) where ``known(name)`` is false."""
    return name if known(name) or "." not in name else name.rsplit(".", 1)[0]


def reader(metric):
    """The module that reads the per-layer metric ``metric``."""
    name = quantity(metric, lambda n: os.path.exists(os.path.join(BENCH, "metrics", n + ".py")))
    return load_module("metrics", name + ".py")


def load_spec(path=SPEC):
    with open(path) as f:
        return json.load(f)


def find(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec, cell):
    """(end-to-end, per-layer) metric entries that this cell reports."""
    def applies(metric):
        return cell["name"] in metric.get("workloads", [cell["name"]])

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in names]
    return e2e, layer


def forbidden_modules():
    """Top-level names in sys.modules that this process must not hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Context:
    """One run of one cell: its parameters, the device, and what the
    traced run records (``record``: spans, counters, the profiled
    sub-window)."""

    def __init__(self, cell, config, traffic, limits, seed, seconds, trace, device):
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.record = {"spans": {}, "counters": {}, "profile": None}
        self.recording = False
        self.state = {}

    def sync(self):
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name):
        """A span of the traced run around a call into a layer, ending at a
        synchronise; recorded in ``record["spans"]`` inside the window, as
        an annotation of the profile inside the profiled sub-window.
        Nothing without ``trace``."""
        if not self.trace:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            self.sync()
            t0 = time.perf_counter()
            yield
            self.sync()
            seconds = time.perf_counter() - t0
        if self.recording:
            self.record["spans"].setdefault(name, []).append(seconds)

    def count(self, name, value):
        if self.recording:
            self.record["counters"][name] = self.record["counters"].get(name, 0) + value

    @contextlib.contextmanager
    def profiled(self):
        """With ``trace``, ``torch.profiler`` over the enclosed steady
        sub-window; the device's timeline is reduced to
        ``record["profile"]`` (see :func:`reduce_profile`)."""
        if not self.trace or self.device == "cpu" or self.record["profile"] is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("window"):
                    yield
                    self.sync()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
            events = events.get("traceEvents", events) if isinstance(events, dict) else events
        self.record["profile"] = reduce_profile(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def reduce_profile(events):
    """The profiled sub-window from a Chrome trace's events: its length
    (``window_s``, the benchmark's "window" annotation), the seconds in
    which a kernel, copy or fill ran on the device (``busy_s``), each
    device operation's total seconds and count, and the longest idle
    gaps, each named by the innermost benchmark span and host operation
    around its middle."""
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and name == "window":
            window = (start, end)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((start, end, name))
        elif cat in ("user_annotation", "cpu_op"):
            host.append((start, end, name, cat))
    if window is None:
        return None
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in device])
    ops = {}
    for s, e, n in device:
        total, count = ops.get(n, (0.0, 0))
        ops[n] = (total + (e - s) * 1e-6, count + 1)
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP_GAPS]:
        mid = 0.5 * (s + e)
        around = [h for h in host if h[0] <= mid <= h[1]]
        spans = [h for h in around if h[3] == "user_annotation" and h[2] != "window"]
        ops_ = [h for h in around if h[3] == "cpu_op"]
        label = "/".join(x for x in (
            min(spans, key=lambda h: h[1] - h[0])[2] if spans else "window",
            min(ops_, key=lambda h: h[1] - h[0])[2] if ops_ else "") if x)
        named.append([label, (e - s) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "ops": ops,
        "gaps": named,
    }


def judged(ctx, compare):
    """The numbers that ``compare()`` gives beside the cell's limits, and
    whether all are finite and within them (a comparison that cannot be
    made is not correct)."""
    try:
        checks = compare()
    except Exception:
        traceback.print_exc()
        checks = [("comparison_ran", math.inf)]
    held = {name: {"value": value, "limit": ctx.limits.get(name, 0.0)} for name, value in checks}
    return bool(held) and all(
        math.isfinite(h["value"]) and h["value"] <= h["limit"] for h in held.values()), held


def run_cell(name, seed, seconds, trace, device="cuda", spec=None, config_overrides=None,
             traffic_overrides=None, t_start=None, control=False):
    """Run the cell ``name`` once and return its result line as a dict
    (without checking for a card: the caller does).  With ``control``
    the line also holds ``control``: the verdict and numbers of the
    driver's control put in the program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    cell = find(spec["workloads"], name, "cell")
    config = dict(load_json("configs", cell["config"] + ".json"), **(config_overrides or {}))
    traffic = dict(load_json("traffic", cell["traffic"] + ".json"), **(traffic_overrides or {}))
    limits = load_json("limits", name + ".json")
    driver = load_module("drivers", traffic["driver"] + ".py")
    e2e, layer = cell_metrics(spec, cell)
    ctx = Context(cell, config, traffic, limits, seed, seconds, trace, device)

    driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    ctx.recording = True
    values = driver.window(ctx)
    ctx.recording = False
    if trace:
        driver.profile(ctx)
    memory_peak = torch.cuda.max_memory_reserved() if device != "cpu" else 0
    t_check = time.perf_counter()
    outputs = {}

    def compare_program():
        outputs["program"] = driver.collect(ctx)
        return driver.check(ctx, outputs["program"])

    correct, held = judged(ctx, compare_program)
    print(f"comparison: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    values["setup_s"] = setup_s

    metrics = {}
    if trace:
        spans = {k: [len(v), sum(v) / len(v), min(v), max(v)] for k, v in ctx.record["spans"].items()}
        print(f"spans [count, mean, min, max] {spans}; counters {ctx.record['counters']}",
              file=sys.stderr)
        for m in layer:
            value = reader(m["name"]).read(ctx.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[quantity(m["name"], values.__contains__)],
                                  "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device != "cpu" else "cpu",
        "kind": torch.cuda.get_device_name() if device != "cpu" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    failed = ctx.state.get("failed", 0)
    result = {"correct": correct and failed == 0, "attempted": ctx.state.get("attempted", 0),
              "failed": failed, "metrics": metrics, "device": device_info}
    profile = ctx.record["profile"]
    if trace and profile is not None:
        device_info["busy_s"] = profile["busy_s"]
        device_info["window_s"] = profile["window_s"]
        top = sorted(profile["ops"].items(), key=lambda kv: -kv[1][0])[:TOP_DEVICE_OPS]
        result["breakdown"] = {"device_ops": [[n[:NAME_CHARS], t] for n, (t, _) in top],
                               "idle_gaps": profile["gaps"]}
    if control:
        verdict, numbers = judged(
            ctx, lambda: driver.check(ctx, driver.control(ctx, outputs["program"])))
        result["control"] = {"correct": verdict, "checks": numbers}
    result["checks"] = held
    return result
