"""The program's spans and counters (``mellon_tpu_torch.utils.profiling``):
off by default, nesting and self time, results bit-identical with tracing
on and off, and each counter and span against what the program reports
of the same work (``select_stable_landmarks``'s steps, L-BFGS's
``n_evals``, NUTS's ``host_reads`` and ``num_evaluations``), and the span
names in ``profiling.trace()``'s Chrome trace."""

import json
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

from _torch_parity import clustered
import mellon_tpu_torch as mt
from mellon_tpu_torch.inference import losses, mcmc
from mellon_tpu_torch.ops import linalg
from mellon_tpu_torch.utils import profiling

# a float32 fit whose landmark kernel is singular: stage 1's pivots prune it
CELLS, DIMS, LANDMARKS = 1200, 5, 600
CHAINS = 4


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty record."""
    profiling.stop()
    profiling.take()
    yield
    profiling.stop()
    profiling.take()


def _traced(fn):
    """``fn()`` with tracing on: (its result, the record)."""
    profiling.start()
    try:
        out = fn()
    finally:
        profiling.stop()
    return out, profiling.take()


def _names(record):
    return Counter(s["name"] for s in record["spans"])


def _fit():
    x = clustered(CELLS, DIMS, seed=31).astype(np.float32)
    est = mt.DensityEstimator(n_landmarks=LANDMARKS, device="cpu")
    est.fit(x)
    return est


@pytest.fixture(scope="module")
def fitted():
    return _fit()


def _nuts_block(est, seed, num_samples=4):
    """A resume_mcmc block of CHAINS chains from the fit's MAP."""
    z = est.pre_transformation.reshape(-1)
    gen = torch.Generator().manual_seed(seed)
    z0 = z + 0.01 * torch.randn((CHAINS, z.shape[0]), generator=gen)
    return mcmc.resume_mcmc(losses.density_loss, z0, gen, 0.1, torch.ones_like(z),
                            num_samples=num_samples, max_tree_depth=5,
                            potential_args=(est.L, est.nn_distances, est.d, est.mu))


def test_off_by_default_records_nothing(fitted):
    assert profiling.span("prepare") is profiling.span("nuts.leaf", torch.device("cpu"))
    with profiling.span("prepare") as inner:
        profiling.count("host_reads")
    assert inner is None
    fitted.predict(fitted.x[:10])
    _nuts_block(fitted, 1, num_samples=1)
    assert profiling.take() == {"spans": [], "counters": {}}


def test_spans_nest_and_self_time_is_the_span_less_its_children():
    def work():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("a", torch.device("cpu")):
                time.sleep(0.003)
                with profiling.span("a.inner"):
                    time.sleep(0.001)
            with profiling.span("b"):
                time.sleep(0.001)
                profiling.count("reads", 2)
        profiling.count("reads")

    _, record = _traced(work)
    spans = record["spans"]
    assert [(s["name"], s["index"], s["parent"]) for s in spans] == [
        ("outer", 0, None), ("a", 1, 0), ("a.inner", 2, 1), ("b", 3, 0)]
    assert record["counters"] == {"reads": 3}
    for s in spans:
        children = [c["host_s"] for c in spans if c["parent"] == s["index"]]
        assert s["self_s"] == pytest.approx(s["host_s"] - sum(children), abs=1e-12)
        assert s["device_s"] is None
    assert spans[0]["self_s"] >= 0.002 and spans[1]["self_s"] >= 0.003
    assert spans[1]["start_s"] >= spans[0]["start_s"]


class _FakeEvent:
    """A CUDA event's calls on a clock the test moves: recorded at the
    clock's time, passed once the device's clock has reached it."""

    created = 0
    host_ms = device_ms = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.created += 1

    def record(self, stream=None):
        self.at = _FakeEvent.host_ms

    def query(self):
        return self.at <= _FakeEvent.device_ms

    def synchronize(self):
        _FakeEvent.device_ms = max(_FakeEvent.device_ms, self.at)

    sync = synchronize

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.at - self.at


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(_FakeEvent, "created", 0)
    monkeypatch.setattr(_FakeEvent, "host_ms", 0.0)
    monkeypatch.setattr(_FakeEvent, "device_ms", 0.0)


def test_device_spans_of_a_name_are_timed_once_per_interval(monkeypatch):
    """The first device span of each name after start() is timed; the
    next ones of that name within DEVICE_SAMPLE_NS are not."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(profiling, "DEVICE_SAMPLE_NS", 10**12)

    def work():
        for name in ("a", "b", "a", "a", "b"):
            with profiling.span(name, torch.device("cuda")):
                _FakeEvent.host_ms += 1.0
            _FakeEvent.device_ms = _FakeEvent.host_ms

    _, record = _traced(work)
    assert [s["device_s"] is not None for s in record["spans"]] == [True, True, False, False, False]
    assert _FakeEvent.created == 4  # two timed spans, two events each


def test_device_spans_resolve_their_events_at_take(monkeypatch):
    """Device spans (on a stand-in for CUDA's events): each span's device
    seconds from its own pair of events, which nothing waits for or reads
    before take()."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(profiling, "DEVICE_SAMPLE_NS", 0)
    waited = []
    monkeypatch.setattr(_FakeEvent, "synchronize",
                        lambda self: waited.append(self) or _FakeEvent.sync(self))

    def work():
        for ms in (1.0, 2.0, 3.0, 4.0):
            with profiling.span("outer"):
                with profiling.span("dev", torch.device("cuda")):
                    _FakeEvent.host_ms += ms
        assert not waited and _FakeEvent.device_ms == 0.0

    _, record = _traced(work)
    dev = [s for s in record["spans"] if s["name"] == "dev"]
    assert [s["device_s"] for s in dev] == pytest.approx([1e-3, 2e-3, 3e-3, 4e-3])
    assert [s["parent"] for s in dev] == [0, 2, 4, 6]
    assert _FakeEvent.created == 8 and len(waited) == 4


def test_a_profiler_session_keeps_the_newest_spans(monkeypatch):
    """Without start(), a torch.profiler session records spans and counts,
    and the record keeps at most PROFILER_MAX_SPANS of them, the newest."""
    monkeypatch.setattr(profiling, "PROFILER_MAX_SPANS", 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(9):
            with profiling.span(f"s{i}"):
                profiling.count("n")
    assert profiling.span("after") is profiling._NOOP
    record = profiling.take()
    assert [s["name"] for s in record["spans"]] == ["s6", "s7", "s8"]
    assert record["counters"] == {"n": 9}


def test_phase_timer_phase_is_a_span():
    timer = profiling.PhaseTimer(log=False)

    def work():
        with timer.phase("alpha"):
            with profiling.span("inside"):
                torch.ones(8).sum()

    _, record = _traced(work)
    assert [(s["name"], s["parent"]) for s in record["spans"]] == [("alpha", None), ("inside", 0)]
    assert set(timer.as_dict()) == {"alpha"}


@pytest.mark.parametrize("work", ["fit", "nuts"])
def test_tracing_changes_no_output(fitted, work):
    """The same seed's fit, and NUTS block, bit for bit with tracing on
    and off."""
    if work == "fit":
        def run():
            est = _fit()
            return est.pre_transformation, est.log_density_x, est.landmarks
    else:
        def run():
            res = _nuts_block(fitted, 7)
            return res.samples, res.potential, res.num_leapfrog

    off = run()
    on, record = _traced(run)
    assert record["spans"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m, rank", [(300, 100), (1100, 1100)])
def test_pivot_steps_count_the_selections_steps(m, rank):
    """``pivot.steps`` adds the steps of each chunk the stopping rule's host
    check lets run: on a rank-100 kernel the first chunk past the rank; on
    a full-rank one of 1,100 landmarks each of the 1,100 steps once (the
    JAX package's cap of 1,024 doubles to 1,100, and its steps are
    continued, not run again), the last chunk short.  One host read per
    chunk, which gives the count; on the CPU no step is the kernel's."""
    gen = torch.Generator().manual_seed(m)
    A = torch.randn((m, rank), dtype=torch.float64, generator=gen) / rank**0.5
    K = A @ A.T if rank < m else torch.eye(m, dtype=torch.float64) + 0.1 * A @ A.T / m
    piv, record = _traced(lambda: linalg.select_stable_landmarks(K, quantize=False))
    chunks = min(-(-m // linalg.PIVOT_CHUNK), rank // linalg.PIVOT_CHUNK + 1)
    steps = min(m, chunks * linalg.PIVOT_CHUNK)
    assert len(piv) == rank
    assert record["counters"] == {"pivot.steps": steps, "host_reads": chunks}
    assert _names(record) == {"prepare.pivots": 1}
    assert steps == (128 if rank < m else 1100)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_fit_counters_match_what_the_fit_reports(precision):
    """``lbfgs.evaluations`` is the result's ``n_evals`` (both phases of
    the bf16 run); ``host_reads`` is the prepare's one read, L-BFGS's
    one per evaluation and the optimistic factor's retries; the prepare's
    spans nest under ``prepare``."""
    x = clustered(CELLS, DIMS, seed=31).astype(np.float32)
    est = mt.DensityEstimator(n_landmarks=LANDMARKS, device="cpu", precision=precision)
    _, record = _traced(lambda: est.fit(x))
    pruned = est.landmarks.shape[0] < LANDMARKS
    assert pruned
    c = record["counters"]
    assert c["lbfgs.evaluations"] == est.opt_state.n_evals
    assert c["host_reads"] == 1 + est.opt_state.n_evals + 1
    assert "pivot.steps" not in c  # stage 1's pivots stopped below the cap
    names = _names(record)
    assert names == {"prepare": 1, "prepare.stage1": 1, "prepare.stage2": 1}
    spans = record["spans"]
    assert [spans[s["parent"]]["name"] for s in spans if s["name"] != "prepare"] == ["prepare"] * 2


def test_nuts_spans_count_the_leaves_and_the_reads(fitted):
    res, record = _traced(lambda: _nuts_block(fitted, 3))
    names = _names(record)
    assert names["nuts.host_read"] == res.host_reads > 0
    assert names["nuts.leaf"] == names["nuts.potential"] == res.num_evaluations // CHAINS > 0
    spans = record["spans"]
    for s in spans:
        if s["name"] == "nuts.potential":
            assert spans[s["parent"]]["name"] == "nuts.leaf"
        elif s["name"] == "nuts.host_read":
            assert s["parent"] is None or spans[s["parent"]]["name"] != "nuts.leaf"
        assert s["device_s"] is None


def test_span_names_in_the_chrome_trace_and_the_record(fitted, tmp_path):
    """``profiling.trace()`` switches tracing on for its block: the spans
    are in the Chrome trace and in the record, and tracing is off after."""
    with profiling.trace(str(tmp_path)):
        assert profiling._on
        fitted.predict(fitted.x[:50])
        _nuts_block(fitted, 5, num_samples=1)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    want = {"predictor.mean", "nuts.leaf", "nuts.potential", "nuts.host_read"}
    assert want <= annotated and not profiling._on
    assert want <= set(_names(profiling.take()))
