"""The comparison that decides ``correct``, broken on purpose: each cell
driven on the CPU at a tiny size (the check for a card skipped) with the
timed path broken underneath (``benchmark/faults.py``) must read
``correct`` false, once for each fault the cell can have; and the
control, the reference at TF32 in the program's place, must fail its
limits.  The cell on a mesh (atlas.nuts4) runs as four gloo ranks on
the CPU, each with the fault planted: the exchange between them, the
cells axis's ``all_reduce`` or the chains axis's gather, left out."""

import json
import math
import types

import pytest

from benchmark import faults, harness
from benchmark.tests.conftest import TINY_CONFIG, TINY_TRAFFIC

# a tiny size whose landmark kernel is singular in float32, so that the
# pivoted selection prunes the landmarks (1,000 to 512)
PRUNED_CONFIG = dict(TINY_CONFIG, cells=2000, dims=10, estimator={"n_landmarks": 1000})


def run(name, config=None, control=False):
    return harness.run_cell(name, 2**31 + 99, 1.0, 0, "cpu",
                            config_overrides=config or TINY_CONFIG,
                            traffic_overrides=TINY_TRAFFIC, control=control)


_SOUND = {}


def sound(name, config=None):
    """The cell's numbers on the same seed without a fault."""
    key = (name, str(config))
    if key not in _SOUND:
        _SOUND[key] = run(name, config)["checks"]
    return _SOUND[key]


@pytest.mark.parametrize("name, fault", [
    ("tutorial.fit", "fit_state_unchanged"),
    ("tutorial.fit", "fit_half_the_cells"),
    ("tutorial.fit", "fit_answer_altered"),
    ("tutorial.fit", "fit_wrong_pivots"),
    ("tutorial.predict", "predict_half_the_batch"),
    ("tutorial.predict", "predict_answer_altered"),
    ("tutorial.nuts", "nuts_state_unchanged"),
    ("tutorial.nuts", "nuts_half_the_cells"),
    ("tutorial.nuts", "nuts_answer_altered"),
])
def test_a_broken_timed_path_is_not_correct(cpu_program, monkeypatch, name, fault):
    """``correct`` is false, and for a number that the same seed's sound
    run holds within its limit (at this tiny size the draws' moments
    carry more Monte Carlo error than at the cell's)."""
    config = PRUNED_CONFIG if fault == "fit_wrong_pivots" else None
    held = sound(name, config)
    getattr(faults, fault)(monkeypatch.setattr)
    result = run(name, config)
    assert result["correct"] is False
    failed = [k for k, v in result["checks"].items() if not v["value"] <= v["limit"]]
    assert any(k not in held or held[k]["value"] <= held[k]["limit"] for k in failed), \
        (result["checks"], held)


@pytest.mark.parametrize("name", ["tutorial.fit", "tutorial.predict", "tutorial.nuts"])
def test_the_control_fails_its_limits(cpu_program, name):
    """The control, judged by the harness's own rule (a control that
    crashes, or reads NaN, has failed), is not correct."""
    result = run(name, control=True)
    assert result["control"]["correct"] is False, result["control"]


MESH_SEED = 2**31 + 99


def _mesh_line(tmp_path, fault):
    """Rank 0's line of one launch of atlas.nuts4's four gloo ranks at the
    tiny size, with ``fault`` planted in every rank (None: sound)."""
    out_path = tmp_path / f"{fault}.out"
    with open(out_path, "w") as out, pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        code = harness.run_ranks(
            "atlas.nuts4", MESH_SEED, 2.0, 0, "cpu", "gloo", 4, stdout=out, timeout=240,
            options=["--config-overrides", json.dumps(TINY_CONFIG), "--traffic-overrides",
                     json.dumps(TINY_TRAFFIC), *(["--fault", fault] if fault else [])])
    assert code == 0
    return json.loads(out_path.read_text().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sound_mesh_line(tmp_path_factory):
    return _mesh_line(tmp_path_factory.mktemp("sound"), None)


@pytest.mark.parametrize("fault", ["mesh_without_the_cells_reduce",
                                   "mesh_without_the_chains_gather", "mesh_chain_group_frozen"])
def test_the_mesh_without_an_exchange_is_not_correct(tmp_path, sound_mesh_line, fault):
    """Each rank samples from its own half of the cells, rank 0 holds its
    own chain group's draws in the other group's place, or a chain group
    never moves: ``correct`` false, by a number that the same seed's
    sound run holds, and that sound run reads true."""
    held, result = sound_mesh_line, _mesh_line(tmp_path, fault)
    assert held["correct"] is True, held["checks"]
    assert result["correct"] is False
    failed = [k for k, v in result["checks"].items() if not v["value"] <= v["limit"]]
    assert any(held["checks"][k]["value"] <= held["checks"][k]["limit"] for k in failed)
    if fault == "mesh_without_the_chains_gather":
        assert failed == ["chains_mismatch"]
        assert result["checks"]["chains_mismatch"]["value"] == TINY_TRAFFIC["chains"] // 2
    if fault == "mesh_chain_group_frozen":
        assert result["checks"]["frozen_chains"]["value"] == TINY_TRAFFIC["chains"] // 2


@pytest.mark.parametrize("value, correct", [(0.5, True), (2.0, False), (math.nan, False),
                                            (math.inf, False)])
def test_the_verdict_holds_each_number_finite_and_within_its_limit(value, correct):
    ctx = types.SimpleNamespace(limits={"gap": 1.0})
    assert harness.judged(ctx, lambda: [("gap", value)])[0] is correct


def test_a_comparison_that_cannot_be_made_is_not_correct():
    def broken():
        raise RuntimeError("no comparison")

    verdict, held = harness.judged(types.SimpleNamespace(limits={}), broken)
    assert verdict is False and held["comparison_ran"]["value"] == math.inf
