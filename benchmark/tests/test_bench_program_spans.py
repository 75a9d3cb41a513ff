"""The readers of the program's own spans and counters
(``benchmark/program_record.py`` and the metrics that read it): each on a
synthetic record, each None without the program's record, the device
metrics None on the CPU, the pivot metrics 0 where no eager selection
ran, and traced tiny CPU runs whose profiled sub-window, profiled on the
CPU as it is on the card, reports the host-clock metrics."""

import contextlib

import pytest
import torch

from benchmark import harness, program_record
from benchmark.tests.conftest import TINY_CONFIG, TINY_TRAFFIC
from mellon_tpu_torch.utils import profiling

FIT = ("fit.stages_ms", "fit.pivots_s", "fit.pivot_steps", "fit.host_reads", "fit.lbfgs_evals")
NUTS = ("nuts.leaf_self_ms", "nuts.potential_ms", "nuts.read_ms")
NEW = FIT + NUTS + ("predict.host_ms",)
DEVICE = ("fit.stages_ms", "nuts.potential_ms")


def _span(name, index, parent, host_s, device_s=None, self_s=None):
    return {"name": name, "index": index, "parent": parent, "start_s": 0.0, "host_s": host_s,
            "device_s": device_s, "self_s": host_s if self_s is None else self_s}


def _record(spans, counters=None):
    return {"spans": {}, "counters": {}, "profile": None,
            "program": {"spans": spans, "counters": counters or {}}}


def _fits(device=True, pivots=True):
    """Two fits: stage 1 of 0.2 and 0.18 s, stage 2 of 0.01 s each (on the
    device), one eager pivot selection of 1.5 s."""
    dev = (lambda s: s) if device else (lambda s: None)
    spans = [_span("prepare", 0, None, 2.0), _span("prepare.stage1", 1, 0, 0.21, dev(0.2)),
             _span("prepare.stage2", 2, 0, 0.02, dev(0.01)),
             _span("prepare", 3, None, 0.4), _span("prepare.stage1", 4, 3, 0.19, dev(0.18)),
             _span("prepare.stage2", 5, 3, 0.02, dev(0.01))]
    counters = {"host_reads": 300, "lbfgs.evaluations": 180}
    if pivots:
        spans.append(_span("prepare.pivots", 6, 0, 1.5))
        counters["pivot.steps"] = 6400
    return _record(spans, counters)


def _leaves(device=True, timed=(0, 1, 2)):
    """Three leaves of 1.2 ms (a potential call of 0.3 ms host, 0.25 ms
    device, in each; ``timed``: the calls the program timed), two reads
    of 0.5 ms."""
    spans, i = [], 0
    for leaf in range(3):
        spans.append(_span("nuts.leaf", i, None, 1.2e-3, self_s=0.9e-3))
        spans.append(_span("nuts.potential", i + 1, i, 0.3e-3,
                           0.25e-3 if device and leaf in timed else None))
        i += 2
    spans += [_span("nuts.host_read", i, None, 0.5e-3), _span("nuts.host_read", i + 1, None, 0.5e-3)]
    return _record(spans)


def _calls():
    return _record([_span("predictor.mean", 0, None, 0.2e-3), _span("predictor.mean", 1, None, 0.4e-3)])


@pytest.mark.parametrize("name, record, want", [
    ("fit.stages_ms", _fits(), 200.0),
    ("fit.pivots_s", _fits(), 0.75),
    ("fit.pivot_steps", _fits(), 3200.0),
    ("fit.host_reads", _fits(), 150.0),
    ("fit.lbfgs_evals", _fits(), 90.0),
    ("nuts.leaf_self_ms", _leaves(), 0.9),
    ("nuts.potential_ms", _leaves(), 0.25),
    ("nuts.potential_ms", _leaves(timed=(0,)), 0.25),
    ("nuts.read_ms", _leaves(), 1.0 / 3),
    ("predict.host_ms", _calls(), 0.3),
])
def test_reader_on_a_synthetic_record(name, record, want):
    assert harness.reader(name).read(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_none_without_the_programs_record(name, monkeypatch):
    """A record whose program keeps none (``program`` None), an empty one,
    and a program without ``profiling.take`` (the parent commit's)."""
    assert harness.reader(name).read(_record([])) is None
    assert harness.reader(name).read(dict(_record([]), program=None)) is None
    monkeypatch.delattr(profiling, "take")
    assert harness.reader(name).read({"spans": {}, "counters": {}, "profile": None}) is None


@pytest.mark.parametrize("name, record", [("fit.stages_ms", _fits(device=False)),
                                          ("nuts.potential_ms", _leaves(device=False))])
def test_device_metrics_are_none_on_the_cpu(name, record):
    assert harness.reader(name).read(record) is None


@pytest.mark.parametrize("name", ["fit.pivots_s", "fit.pivot_steps"])
def test_pivot_metrics_read_zero_without_an_eager_selection(name):
    assert harness.reader(name).read(_fits(pivots=False)) == 0


def test_the_record_is_taken_once():
    profiling.start()
    with profiling.span("predictor.mean"):
        pass
    profiling.stop()
    record = {"spans": {}, "counters": {}, "profile": None}
    first = program_record.program(record)
    assert [s["name"] for s in first["spans"]] == ["predictor.mean"]
    assert program_record.program(record) is first
    assert harness.reader("predict.host_ms").read(record) > 0


@contextlib.contextmanager
def _cpu_profiled(self):
    """``Context.profiled`` with the CPU's profiler: the card's profiled
    sub-window without its device timeline."""
    if not self.trace:
        yield
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        yield


@pytest.mark.parametrize("name, want", [
    ("tutorial.fit", {"fit.pivot_steps", "fit.host_reads", "fit.lbfgs_evals", "fit.pivots_s"}),
    ("tutorial.nuts", {"nuts.leaf_self_ms", "nuts.read_ms"}),
    ("tutorial.predict", {"predict.host_ms"}),
])
def test_traced_tiny_runs_report_the_host_clock_metrics(cpu_program, monkeypatch, name, want):
    profiling.take()
    monkeypatch.setattr(harness.Context, "profiled", _cpu_profiled)
    result = harness.run_cell(name, 2**31 + 11, 1.0, 1, "cpu",
                              config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC)
    metrics = result["metrics"]
    assert want <= set(metrics) and not set(DEVICE) & set(metrics)
    assert all(metrics[m]["value"] >= 0 for m in want)
    if name == "tutorial.fit":
        # the tiny fit's pivots stop inside stage 1: no eager selection
        assert metrics["fit.pivot_steps"]["value"] == 0 and metrics["fit.host_reads"]["value"] > 1
        assert metrics["fit.lbfgs_evals"]["value"] > 0
