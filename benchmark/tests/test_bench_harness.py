"""The harness against the contract: every name resolves to its file, the
result line has the contract's keys, a configuration, traffic mix or
metric is added by files and entries alone, and nothing imports JAX or
the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from benchmark.tests.conftest import ROOT, TINY_CONFIG, TINY_TRAFFIC

BENCH = os.path.join(ROOT, "benchmark")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_name_resolves_to_its_file():
    spec = harness.load_spec()
    assert spec["paths"] == ["benchmark"]
    for config in spec["configs"]:
        assert config["file"] == f"benchmark/configs/{config['name']}.json"
        assert harness.load_json("configs", config["name"] + ".json")["name"] == config["name"]
    for cell in spec["workloads"]:
        traffic = harness.load_json("traffic", cell["traffic"] + ".json")
        assert os.path.exists(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "limits", cell["name"] + ".json"))
        e2e, layer = harness.cell_metrics(spec, cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for metric in spec["per_layer"]:
        assert callable(harness.reader(metric["name"]).read)


@pytest.mark.parametrize("name, trace", [("tutorial.fit", 0), ("tutorial.nuts", 1),
                                         ("tutorial.predict", 1)])
def test_result_line_has_the_contract_keys(cpu_program, name, trace):
    result = harness.run_cell(name, 2**31 + 7, 1.0, trace, "cpu",
                              config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = harness.load_spec()
    e2e, layer = harness.cell_metrics(spec, harness.find(spec["workloads"], name, "cell"))
    if trace:
        # on the CPU the profiler's readers find nothing, and say so; the
        # spans' and counters' readers find theirs
        assert set(result["metrics"]) <= {m["name"] for m in layer}
        if name == "tutorial.nuts":
            assert {"nuts.ess_per_draw", "nuts.host_reads_per_leaf"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
    for held in result["checks"].values():
        assert set(held) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_the_command_exits_without_a_result(tmp_path):
    """No CUDA device (as on this CPU machine), or a directory with only
    BENCHMARK.json and the benchmark: a code other than 0, no result."""
    if _cuda_available():
        pytest.skip("a CUDA device is present")
    copy = tmp_path / "alone"
    copy.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, copy):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tutorial.fit",
                               "--seed", "1", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def _cuda_available():
    import torch

    return torch.cuda.is_available()


EXTRA_METRIC = '''"""The number of fits in the window."""


def read(record):
    return float(record["counters"].get("fits", 0)) or None
'''


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """In a copy: a new configuration, traffic mix, limits and per-layer
    metric, as new files and new entries of BENCHMARK.json, run with the
    copied harness untouched."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    config = dict(harness.load_json("configs", "tutorial_8627x20.json"), name="extra_cfg",
                  **TINY_CONFIG)
    (tmp_path / "benchmark/configs/extra_cfg.json").write_text(json.dumps(config))
    traffic = dict(harness.load_json("traffic", "fit_back_to_back.json"), data_sets=2,
                   warmup_fits=1, checked_fits=1)
    (tmp_path / "benchmark/traffic/extra_mix.json").write_text(json.dumps(traffic))
    limits = harness.load_json("limits", "tutorial.fit.json")
    (tmp_path / "benchmark/limits/extra.cell.json").write_text(json.dumps(limits))
    (tmp_path / "benchmark/metrics/extra.fits.py").write_text(EXTRA_METRIC)
    spec["configs"].append({"name": "extra_cfg", "source": "https://example.org/extra",
                            "file": "benchmark/configs/extra_cfg.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "extra.cell", "config": "extra_cfg",
                              "traffic": "extra_mix", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("extra.cell")
    spec["per_layer"].append({"name": "extra.fits", "unit": "fits", "better": "higher",
                              "source": "program_counter", "layer": "estimator",
                              "moves": "fit_s", "workloads": ["extra.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = (
        "import json, sys, torch\n"
        "import mellon_tpu_torch.config as c\n"
        "c.DEFAULT_DEVICE = 'cpu'\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "assert harness.BENCH.startswith(sys.argv[1])\n"
        "r = harness.run_cell('extra.cell', 11, 1.0, 1, 'cpu')\n"
        "print(json.dumps(r['metrics']))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["extra.fits"]["value"] >= 1 and "fit.prepare_s" not in metrics


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules(*parts):
    for dirpath, _, files in os.walk(os.path.join(BENCH, *parts)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _modules():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        for name in _imports(path):
            assert name.split(".")[0] in {"math", "torch"}, (path, name)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mellon_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mellon_tpu.inference", sys)
    assert harness.forbidden_modules() == ["mellon_tpu"]
