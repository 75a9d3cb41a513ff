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
place; only ``control.py`` asks for it (``run(..., control=True)``),
the benchmark's runs never call it.

:func:`run` runs a cell as its ``chips`` ask, for ``run.py`` and
``control.py`` alike.  A cell whose ``chips`` is 1 runs in the calling
process.  A cell whose ``chips`` is N > 1 runs as N rank processes, one
per device (:func:`run_ranks`; each rank is ``rank.py``, which joins the
process group and calls :func:`run_cell` on ``cuda:<rank>``).  The
driver then runs on every rank, and its ``setup``, ``window``,
``profile`` and ``collect`` may use the group's collectives
(``ctx.rank``, ``ctx.world``, ``ctx.devices``); rank 0 alone runs
``check`` and writes the one result line, whose ``device`` is assembled
from every rank's device (:func:`device_facts`), and which no rank's
JAX lets through (:func:`refusal`).  A cell on
several devices is added, as any other, by files and entries alone: its
driver and traffic mix say how the ranks share the work.

An end-to-end metric ``<quantity>.<qualifier>`` is the driver's
``<quantity>`` under a name of its own, so that cells whose spreads
differ take bounds of their own (``ess_per_s.atlas``); a per-layer
metric so split is read by ``metrics/<name>.py`` where that file exists,
else by the file of the name without its last qualifier.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
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
# a rank that waits longer than this in a collective fails (the process
# group's timeout), well inside a run's 360 s
PG_TIMEOUT_S = 240
# the whole launch of a cell's ranks, inside the 1,200 s that a checkout's
# first run may take
LAUNCH_TIMEOUT_S = 1150
RANK_POLL_S = 0.2


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

    def __init__(self, cell, config, traffic, limits, seed, seconds, trace, device, rank=0,
                 devices=None):
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        # this rank, and every rank's device in rank order
        self.rank, self.devices = rank, devices or [device]
        self.world = len(self.devices)
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
        ``record["profile"]`` (see :func:`reduce_profile`).  With several
        ranks every rank must enter it: the sub-window opens together."""
        if not self.trace or self.device == "cpu" or self.record["profile"] is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if self.world > 1:
                    # the sub-window opens once every rank's profiler runs: a
                    # rank whose profiler starts first would otherwise read
                    # its wait for the others in its first collective as busy
                    import torch.distributed as dist

                    dist.barrier()
                    self.sync()
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
             traffic_overrides=None, t_start=None, control=False, rank=0, devices=None):
    """Run the cell ``name`` once and return its result line as a dict
    (without checking for a card: the caller does).  With ``control``
    the line also holds ``control``: the verdict and numbers of the
    driver's control put in the program's place.

    As one rank of several (``devices``: every rank's device, this one's
    ``devices[rank]``, in a process group already joined), every rank
    runs the driver up to ``collect``; then the ranks gather their
    device facts, and rank 0 checks and returns the line while the
    others return None."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    cell = find(spec["workloads"], name, "cell")
    config = dict(load_json("configs", cell["config"] + ".json"), **(config_overrides or {}))
    traffic = dict(load_json("traffic", cell["traffic"] + ".json"), **(traffic_overrides or {}))
    limits = load_json("limits", name + ".json")
    driver = load_module("drivers", traffic["driver"] + ".py")
    e2e, layer = cell_metrics(spec, cell)
    ctx = Context(cell, config, traffic, limits, seed, seconds, trace, device, rank, devices)

    driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    ctx.recording = True
    values = driver.window(ctx)
    ctx.recording = False
    if trace:
        driver.profile(ctx)
    fact = rank_fact(ctx)
    t_check = time.perf_counter()
    outputs = {}

    def compare_program():
        outputs["program"] = driver.collect(ctx)
        return driver.check(ctx, outputs["program"])

    if ctx.world == 1:
        facts = [fact]
        correct, held = judged(ctx, compare_program)
    else:
        # collect's collectives run on every rank; a rank that fails there ends the run
        import torch.distributed as dist

        outputs["program"] = driver.collect(ctx)
        # what each rank's process holds once its part of the run is over
        fact["forbidden"] = forbidden_modules()
        facts = [None] * ctx.world
        dist.all_gather_object(facts, fact)
        if rank != 0:
            return None
        correct, held = judged(ctx, lambda: driver.check(ctx, outputs["program"]))
    print(f"comparison: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    values["setup_s"] = setup_s
    device_info = device_facts(facts)
    profile = ctx.record["profile"]
    if trace and profile is not None and "busy_s" in device_info:
        # the readers' idle share is the devices' mean, as the line's
        profile.update(busy_s=device_info["busy_s"], window_s=device_info["window_s"])

    metrics = {}
    if trace:
        spans = {k: [len(v), sum(v) / len(v), min(v), max(v)]
                 for k, v in ctx.record["spans"].items()}
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
    failed = ctx.state.get("failed", 0)
    result = {"correct": correct and failed == 0, "attempted": ctx.state.get("attempted", 0),
              "failed": failed, "metrics": metrics, "device": device_info}
    held_by_ranks = {r: f["forbidden"] for r, f in enumerate(facts) if f.get("forbidden")}
    if held_by_ranks:
        # never printed: emit() refuses a line that carries it
        result["forbidden"] = held_by_ranks
    if trace and profile is not None:
        top = sorted(profile["ops"].items(), key=lambda kv: -kv[1][0])[:TOP_DEVICE_OPS]
        result["breakdown"] = {"device_ops": [[n[:NAME_CHARS], t] for n, (t, _) in top],
                               "idle_gaps": profile["gaps"]}
    if control:
        verdict, numbers = judged(
            ctx, lambda: driver.check(ctx, driver.control(ctx, outputs["program"])))
        result["control"] = {"correct": verdict, "checks": numbers}
    result["checks"] = held
    return result


def rank_fact(ctx):
    """This rank's device once the window and its profile are over:
    platform, CUDA index, name, peak memory, and from a profiled
    sub-window its busy and window seconds."""
    import torch

    if ctx.device == "cpu":
        fact = {"platform": "cpu", "index": None, "kind": "cpu", "memory_peak_bytes": 0}
    else:
        index = torch.cuda.current_device()
        fact = {"platform": "gpu", "index": index, "kind": torch.cuda.get_device_name(index),
                "memory_peak_bytes": int(torch.cuda.max_memory_reserved(index))}
    profile = ctx.record["profile"]
    if ctx.trace and profile is not None:
        fact.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
    return fact


def device_facts(facts):
    """The result line's ``device`` from every rank's :func:`rank_fact`:
    ``count`` the distinct devices (platform and CUDA index) the ranks ran
    on, ``kind`` their name (ValueError where the ranks' names differ),
    ``memory_peak_bytes`` the fullest device's peak; with profiles
    ``busy_s`` and ``window_s`` the ranks' means, so that the idle share
    is the mean over the devices; with several ranks ``per_device``, each
    rank's index, peak, and busy and window seconds."""
    kinds = sorted({f["kind"] for f in facts})
    if len(kinds) != 1:
        raise ValueError(f"the ranks ran on devices of different kinds: {kinds}")
    info = {
        "platform": facts[0]["platform"],
        "kind": kinds[0],
        "count": len({(f["platform"], f["index"]) for f in facts}),
        "memory_peak_bytes": max(f["memory_peak_bytes"] for f in facts),
    }
    if all("busy_s" in f for f in facts):
        for key in ("busy_s", "window_s"):
            info[key] = sum(f[key] for f in facts) / len(facts)
    if len(facts) > 1:
        info["per_device"] = [
            {k: f[k] for k in ("index", "memory_peak_bytes", "busy_s", "window_s") if k in f}
            for f in facts]
    return info


def refusal(result, chips):
    """Why the result line may not be printed, or None: this process, or
    a rank of the run (``result["forbidden"]``, from the ranks' gathered
    facts), holds JAX or the JAX package, or the line's devices are fewer
    than the ``chips`` that the cell asks for."""
    found = forbidden_modules()
    if found:
        return f"the process holds {', '.join(found)} after the window"
    if result.get("forbidden"):
        held = "; ".join(f"rank {r}: {', '.join(names)}"
                         for r, names in sorted(result["forbidden"].items()))
        return f"ranks of the run hold forbidden modules after the window ({held})"
    count = result["device"]["count"]
    if count < chips:
        return f"the run used {count} distinct device(s); the cell asks for {chips}"
    return None


def emit(result, chips):
    """Print the result line, as the last line of standard output, and
    each number compared beside its limit as the last lines of standard
    error; returns the exit code.  Prints no result, and returns 2, where
    :func:`refusal` gives a reason."""
    reason = refusal(result, chips)
    if reason:
        print(reason, file=sys.stderr)
        return 2
    for name, held in result["checks"].items():
        print(f"check {name} {held['value']!r} limit {held['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(name, seed, seconds, trace, spec=None, t_start=None, control=False, fault=None):
    """Run the cell ``name`` once on CUDA devices, as many as its ``chips``
    (without checking for them: the caller does), and return (exit code,
    result line or None).  One device: in this process
    (:func:`run_cell`).  N > 1: as N rank processes in one NCCL process
    group (:func:`run_ranks`), whose rank 0's line is read back.
    ``control`` asks for the control's verdict in the line; ``fault``
    plants that fault of ``benchmark/faults.py`` in the program for this
    run (in every rank), and takes it out again after it."""
    spec = load_spec() if spec is None else spec
    chips = int(find(spec["workloads"], name, "cell")["chips"])
    if chips == 1:
        with _planted(fault):
            return 0, run_cell(name, seed, seconds, trace, "cuda", spec=spec, t_start=t_start,
                               control=control)
    options = ["--fault", fault] if fault else []
    options += ["--control"] if control else []
    with tempfile.TemporaryFile("w+") as out:
        code = run_ranks(name, seed, seconds, trace, "cuda", "nccl", chips, stdout=out,
                         options=options)
        out.seek(0)
        lines = out.read().strip().splitlines()
    if code == 0 and not lines:
        print("rank 0 ended without a result line", file=sys.stderr)
        code = 1
    return code, json.loads(lines[-1]) if code == 0 else None


@contextlib.contextmanager
def _planted(fault):
    """The fault ``fault`` of ``benchmark/faults.py`` (None: none) planted
    while the block runs, every patched attribute restored after it."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if fault:
        from benchmark import faults

        getattr(faults, fault)(patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)


# ---------------------------------------------------------------------------
# a cell on several devices: one rank process per device
# ---------------------------------------------------------------------------


def run_ranks(name, seed, seconds, trace, device, backend, world, stdout=None, options=(),
              timeout=LAUNCH_TIMEOUT_S):
    """Run the cell ``name`` once as ``world`` rank processes (``rank.py``)
    in one process group over ``backend`` (``torch.distributed``: "nccl",
    or "gloo" on the CPU), rank r on ``cuda:<r>`` where ``device`` is
    "cuda", every rank on the CPU where it is "cpu".  Rank 0 writes the
    result line to ``stdout`` (a file; this process's standard output by
    default), the others write to standard error only.  ``options`` are
    more arguments of ``rank.py`` (``--control``, ``--fault <name>``,
    ``--config-overrides <json>``, ...).

    Waits for every rank and returns the exit code: 0 where every rank
    ended with 0; else the first failed rank's code (128 + the signal for
    one killed), or 124 past ``timeout`` seconds, once the other ranks
    are killed.  A rank that waits in a collective for one that failed
    is ended by that kill, or by the process group's timeout; a rank
    whose launcher dies is killed with it (``rank.py``)."""
    t0 = time.time()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(world):
                rank_device = f"cuda:{r}" if device == "cuda" else device
                cmd = [sys.executable, os.path.join(BENCH, "rank.py"), "--workload", name,
                       "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace)),
                       "--rank", str(r), "--world", str(world), "--device", rank_device,
                       "--backend", backend, "--store", os.path.join(tmp, "store"),
                       "--t0", repr(t0), "--parent", str(os.getpid()), *options]
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                           TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
                # the host's cores shared out, as one process on one device has its own
                env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
                procs.append(subprocess.Popen(cmd, env=env, stdout=stdout if r == 0 else 2))
            return _wait_for_ranks(procs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()


def _wait_for_ranks(procs, timeout):
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                print(f"rank {rank} exited with {code}; ending the other ranks", file=sys.stderr)
                return code if code > 0 else 128 - code
        if all(code == 0 for code in codes):
            return 0
        if time.monotonic() > deadline:
            print(f"the ranks ran past {timeout} s; ending them", file=sys.stderr)
            return 124
        time.sleep(RANK_POLL_S)


def rank_main(argv=None):
    """One rank of :func:`run_ranks` (``rank.py``'s arguments): join the
    process group, run the cell (with ``--fault`` planted, ``--control``
    asked for), and on rank 0 print the line (without the checks on
    standard error, which the launcher's :func:`emit` prints), unless
    :func:`refusal` gives a reason.  A rank that raises ends its process
    at once, with 1, without waiting for the others."""
    parser = argparse.ArgumentParser(description="one rank of a cell on several devices")
    for flag, kind in (("--workload", str), ("--seed", int), ("--seconds", float),
                       ("--trace", int), ("--rank", int), ("--world", int), ("--device", str),
                       ("--backend", str), ("--store", str), ("--t0", float)):
        parser.add_argument(flag, type=kind, required=True)
    parser.add_argument("--parent", type=int)
    parser.add_argument("--config-overrides", type=json.loads)
    parser.add_argument("--traffic-overrides", type=json.loads)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault")
    args = parser.parse_args(argv)
    # the launch's start: set-up counts from it, as a one-device run's
    # counts from its process's start
    t_start = time.perf_counter() - (time.time() - args.t0)
    try:
        import datetime

        import torch.distributed as dist

        if args.device == "cpu":
            import mellon_tpu_torch.config as program_config

            program_config.DEFAULT_DEVICE = "cpu"
        from mellon_tpu_torch import parallel

        if args.fault:
            from benchmark import faults

            getattr(faults, args.fault)(setattr)
        parallel.distributed_initialize(
            args.backend, device=args.device, rank=args.rank, world_size=args.world,
            store=dist.FileStore(args.store, args.world),
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        devices = [f"cuda:{r}" if args.device.startswith("cuda") else args.device
                   for r in range(args.world)]
        spec = load_spec()
        result = run_cell(args.workload, args.seed, args.seconds, args.trace, args.device,
                          spec=spec, config_overrides=args.config_overrides,
                          traffic_overrides=args.traffic_overrides, t_start=t_start,
                          control=args.control, rank=args.rank, devices=devices)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if result is None:
        return 0
    chips = int(find(spec["workloads"], args.workload, "cell")["chips"])
    reason = refusal(result, chips if args.device != "cpu" else 1)
    if reason:
        print(reason, file=sys.stderr)
        return 2
    # the launcher (:func:`run`) prints the checks and the line again
    print(json.dumps(result), flush=True)
    return 0
