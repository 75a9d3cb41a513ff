"""Program spans and counters, phase timers and device tracing
(counterpart of ``mellon_tpu/utils/profiling.py``).

* :func:`span` and :func:`count`: the program's spans and counters, at the
  places where its work happens (the fused prepare's stages, the pivot
  selection, L-BFGS, the NUTS leaf, the predictor call).  Tracing is off
  by default, and then a span is one shared no-op context and a count
  does nothing.  It is on between :func:`start` and :func:`stop`.  While
  it is on, every span is kept in memory (name, enclosing span, host
  clock, and with ``device`` a pair of CUDA events on that device's
  stream, for one span of each name per :data:`DEVICE_SAMPLE_NS`) until
  :func:`take` returns the record, and under a ``torch.profiler`` session
  it also opens ``torch.profiler.record_function`` of its name.  No span
  synchronises, none sits inside a function that a CUDA graph captures,
  and tracing changes no result;
* a ``torch.profiler`` session records spans and counts too, without
  :func:`start`, keeping the newest :data:`PROFILER_MAX_SPANS` spans: the
  benchmark's traced run reads the program's record of its profiled
  sub-window this way.  So the off path also asks whether a profiler
  records (one C call); this switch goes once the benchmark's harness
  calls :func:`start` and :func:`take` itself;
* :class:`PhaseTimer`: named wall-clock phases whose end waits for the
  device of the tensors handed to the phase (``torch.cuda.synchronize`` on
  each CUDA device among them), collected into a report; each phase is a
  span of its label;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace, the program's spans among its events, into a directory,
  with tracing on.
"""

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("mellon_tpu_torch")

_NOOP = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
# switched by start() and stop()
_on = False
# the record: one list per span in the order the spans opened,
# [name, enclosing span's list or None, host start ns, host end ns,
#  start event, end event], and the counters
_spans = []
_counters = {}
# the open spans' lists, innermost last
_open = []
# a device span records its events only where the last span of its name
# that did opened this long before or more: creating, recording and
# reading a pair of events took 20-60 us of host time on an H100
# machine, and timing every leaf's potential slowed NUTS at the
# tutorial's size by 22-33% (PERF.md)
DEVICE_SAMPLE_NS = 20_000_000
_last_timed = {}
# without start(), under a profiler, the record keeps at most this many
# spans, the newest: halved to the newest half when it reaches it
PROFILER_MAX_SPANS = 1 << 16


class _Span:
    """A span while tracing is on (see :func:`span`)."""

    __slots__ = ("_name", "_stream", "_entry", "_function")

    def __init__(self, name, device):
        self._name = name
        self._stream = None
        if device is not None and getattr(device, "type", None) == "cuda":
            now = time.perf_counter_ns()
            if now - _last_timed.get(name, -DEVICE_SAMPLE_NS) >= DEVICE_SAMPLE_NS:
                _last_timed[name] = now
                self._stream = torch.cuda.current_stream(device)

    def __enter__(self):
        entry = self._entry = [self._name, _open[-1] if _open else None, 0, None, None, None]
        # the annotation serves a profiler's timeline only
        self._function = None
        if _profiler_enabled():
            self._function = torch.profiler.record_function(self._name)
            self._function.__enter__()
            if not _on and len(_spans) >= PROFILER_MAX_SPANS:
                del _spans[:PROFILER_MAX_SPANS // 2]
        _spans.append(entry)
        _open.append(entry)
        if self._stream is not None:
            entry[4] = torch.cuda.Event(enable_timing=True)
            entry[4].record(self._stream)
        entry[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        entry = self._entry
        if self._stream is not None:
            entry[5] = torch.cuda.Event(enable_timing=True)
            entry[5].record(self._stream)
        entry[3] = time.perf_counter_ns()
        if _open and _open[-1] is entry:
            _open.pop()
        if self._function is not None:
            self._function.__exit__(*exc)
        return False


def span(name, device=None):
    """A context manager around one piece of the program's work, recorded
    while tracing is on (:func:`start`, or a ``torch.profiler`` session);
    else the shared no-op context.  With ``device`` a CUDA ``torch.device``, the
    span also records a CUDA event on that device's current stream at
    each end, resolved by :func:`take` into device seconds: the time the
    device took from the work enqueued before the span to the work
    enqueued in it, idle time included.  Of a name's device spans, those
    that open within :data:`DEVICE_SAMPLE_NS` of the last timed one are
    not timed (their ``device_s`` is None): the first of each name after
    :func:`start` is."""
    if not (_on or _profiler_enabled()):
        return _NOOP
    return _Span(name, device)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on or _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def start():
    """Switch tracing on, with an empty record."""
    global _on
    _spans.clear()
    _counters.clear()
    _open.clear()
    _last_timed.clear()
    _on = True


def stop():
    """Switch tracing off; the record stays until :func:`take`."""
    global _on
    _on = False


def take():
    """The record since :func:`start` or the last take, which starts a new
    one: ``{"spans": [...], "counters": {name: total}}``.  Each span, in
    the order the spans opened, is a dict of ``name``, ``index`` (its
    place in the list), ``parent`` (the index of the span that enclosed
    it, or None), ``start_s`` (the host clock, ``time.perf_counter``'s
    seconds), ``host_s``, ``device_s`` (None where it recorded no events) and
    ``self_s`` (``host_s`` less the host seconds of the spans directly
    inside it).  Spans still open are left out.  The device spans' events
    are waited for here, and only here."""
    global _spans, _counters
    entries, counters = [e for e in _spans if e[3] is not None], _counters
    _spans, _counters = [], {}
    index = {id(e): i for i, e in enumerate(entries)}
    spans = []
    for i, (name, parent, t0, t1, start_event, end_event) in enumerate(entries):
        device_s = None
        if end_event is not None:
            end_event.synchronize()
            device_s = start_event.elapsed_time(end_event) * 1e-3
        spans.append({
            "name": name, "index": i,
            "parent": index.get(id(parent)) if parent is not None else None,
            "start_s": t0 * 1e-9, "host_s": (t1 - t0) * 1e-9,
            "device_s": device_s, "self_s": (t1 - t0) * 1e-9,
        })
    for s in spans:
        if s["parent"] is not None:
            spans[s["parent"]]["self_s"] -= s["host_s"]
    return {"spans": spans, "counters": counters}


def _cuda_devices(values):
    return {v.device for v in values if isinstance(v, torch.Tensor) and v.device.type == "cuda"}


class PhaseTimer:
    """Collect named phase durations with device-synchronized ends."""

    def __init__(self, name="mellon_tpu_torch", log=True):
        self.name = name
        self.log = log
        self.phases = []

    @contextlib.contextmanager
    def phase(self, label, *sync_tensors):
        """Time a phase, a :func:`span` of ``label``; the clock stops once
        the CUDA devices of ``sync_tensors`` are done (otherwise
        asynchronous launches hide the device time).  Other values are
        ignored."""
        t0 = time.perf_counter()
        with span(label):
            try:
                yield
            finally:
                for device in _cuda_devices(sync_tensors):
                    torch.cuda.synchronize(device)
                elapsed = time.perf_counter() - t0
                self.phases.append((label, elapsed))
                if self.log:
                    logger.info("[%s] %s: %.3fs", self.name, label, elapsed)

    def sync(self):
        """Wait for all outstanding work on the current CUDA device."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def report(self):
        total = sum(t for _, t in self.phases)
        lines = [f"{self.name} phase report (total {total:.3f}s):"]
        for label, t in self.phases:
            share = 100 * t / total if total > 0 else 0
            lines.append(f"  {label:<32s} {t:>9.3f}s {share:>5.1f}%")
        return "\n".join(lines)

    def as_dict(self):
        return dict(self.phases)


@contextlib.contextmanager
def trace(log_dir="mellon_tpu_torch_trace"):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where
    a device is available) and write its Chrome trace to
    ``<log_dir>/trace.json``, the program's spans among its
    ``user_annotation`` events; yields ``log_dir``.  Tracing is on for the
    block (:func:`start` and :func:`stop`, unless it was on already), so
    the block's spans also wait for :func:`take`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    started = not _on
    if started:
        start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
    finally:
        if started:
            stop()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote profiler trace to %s.", path)
