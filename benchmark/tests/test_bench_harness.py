"""The harness against the contract: every name resolves to its file, the
result line has the contract's keys, a configuration, traffic mix or
metric is added by files and entries alone, and nothing imports JAX or
the JAX package.  A cell on several devices runs as one rank process per
device (here four gloo ranks on the CPU): rank 0 alone prints the line,
whose devices are counted from the ranks', and a rank that fails ends
the launch."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

from benchmark.tests.conftest import ROOT, TINY_CONFIG, TINY_TRAFFIC

BENCH = os.path.join(ROOT, "benchmark")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the time limit of one launch of a tiny cell's four CPU ranks
RANKS_TIMEOUT_S = 240
TINY_OPTIONS = ["--config-overrides", json.dumps(TINY_CONFIG),
                "--traffic-overrides", json.dumps(TINY_TRAFFIC)]


def run_tiny_ranks(tmp_path, name="atlas.nuts4", trace=0, options=()):
    """(exit code, rank 0's standard output) of one launch of the cell's
    four ranks on the CPU at the tiny size."""
    out_path = tmp_path / f"rank0_{trace}.out"
    with open(out_path, "w") as out:
        code = harness.run_ranks(name, 2**31 + 7, 2.0, trace, "cpu", "gloo", 4, stdout=out,
                                 options=[*TINY_OPTIONS, *options], timeout=RANKS_TIMEOUT_S)
    return code, out_path.read_text()


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


@pytest.mark.parametrize("trace", [0, 1])
def test_a_mesh_cell_runs_one_rank_process_per_device(tmp_path, capfd, monkeypatch, trace):
    """atlas.nuts4 as four gloo ranks on the CPU: one line, rank 0's, with
    the contract's keys and every rank's device; the others print to
    standard error alone."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    code, out = run_tiny_ranks(tmp_path, trace=trace)
    assert code == 0, capfd.readouterr().err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1 and capfd.readouterr().out == ""
    result = json.loads(lines[0])
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    device = result["device"]
    assert device["count"] == 1 and device["platform"] == "cpu"  # four ranks, one CPU
    assert len(device["per_device"]) == 4
    spec = harness.load_spec()
    _, layer = harness.cell_metrics(spec, harness.find(spec["workloads"], "atlas.nuts4", "cell"))
    if trace:
        assert {"nuts.ess_per_draw.atlas4", "nuts.host_reads_per_leaf.atlas4",
                "nuts_leaf_mfu.atlas4"} <= set(result["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(result["metrics"]) == {"ess_per_s.atlas4", "setup_s"}
        assert result["correct"] is True, result["checks"]


def test_a_one_device_line_keeps_its_device_keys(cpu_program):
    result = harness.run_cell("tutorial.predict", 2**31 + 7, 1.0, 0, "cpu",
                              config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC)
    assert list(result["device"]) == ["platform", "kind", "count", "memory_peak_bytes"]
    assert result["device"]["count"] == 1


H100 = "NVIDIA H100 80GB HBM3"


def _fact(index, peak, busy=None, kind=H100):
    fact = {"platform": "gpu", "index": index, "kind": kind, "memory_peak_bytes": peak}
    if busy is not None:
        fact.update(busy_s=busy, window_s=1.0)
    return fact


def test_the_device_is_counted_from_the_ranks_facts(capsys):
    """Four ranks on four cards: count 4, the fullest card's peak, the
    mean busy share, each rank's entry; two ranks on one card count 1,
    and a cell that asks for 2 then prints no line; ranks on cards of
    two kinds are refused."""
    info = harness.device_facts([_fact(i, 10 + i, busy=0.1 * i) for i in range(4)])
    assert (info["count"], info["memory_peak_bytes"], info["kind"]) == (4, 13, H100)
    assert info["busy_s"] == pytest.approx(0.15) and info["window_s"] == 1.0
    assert [d["index"] for d in info["per_device"]] == [0, 1, 2, 3]
    shared = harness.device_facts([_fact(0, 5), _fact(0, 7)])
    assert shared["count"] == 1 and shared["memory_peak_bytes"] == 7
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": shared,
              "checks": {}}
    assert harness.emit(result, 2) == 2
    assert capsys.readouterr().out == ""
    assert harness.emit(dict(result, device=harness.device_facts([_fact(0, 5), _fact(1, 7)])),
                        2) == 0
    assert json.loads(capsys.readouterr().out)["device"]["count"] == 2
    with pytest.raises(ValueError):
        harness.device_facts([_fact(0, 5), _fact(1, 5, kind="NVIDIA A100")])


FAILING_DRIVER = '''"""Rank 1 fails in set-up; the other ranks wait for it in a collective."""
import os

import torch.distributed as dist


def setup(ctx):
    with open(os.path.join(os.environ["RANK_PIDS"], f"{ctx.rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if ctx.rank == 1:
        raise RuntimeError("a rank that fails")
    dist.barrier()
'''


def test_a_failing_rank_ends_the_launch(tmp_path):
    """Rank 1 raises while the others wait in a barrier: the launch exits
    non-zero at once, far inside the process group's timeout, and leaves
    no rank behind."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/drivers/fails.py").write_text(FAILING_DRIVER)
    (tmp_path / "benchmark/traffic/fails.json").write_text(json.dumps({"driver": "fails"}))
    (tmp_path / "benchmark/limits/fail.cell.json").write_text("{}")
    spec = harness.load_spec()
    spec["workloads"].append({"name": "fail.cell", "config": "tutorial_8627x20",
                              "traffic": "fails", "chips": 4, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    pids = tmp_path / "pids"
    pids.mkdir()
    script = ("import sys\n"
              "from benchmark import harness\n"
              "code = harness.run_ranks('fail.cell', 1, 1.0, 0, 'cpu', 'gloo', 4, timeout=120)\n"
              "sys.exit(code)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]), RANK_PIDS=str(pids),
               OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=RANKS_TIMEOUT_S)
    seconds = time.monotonic() - t0
    assert proc.returncode == 1 and proc.stdout == "", proc.stderr[-3000:]
    assert "a rank that fails" in proc.stderr and seconds < harness.PG_TIMEOUT_S / 4
    assert len(list(pids.iterdir())) >= 2
    for pid_file in pids.iterdir():
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid_file.read_text()), 0)


HOLDS_JAX_DRIVER = '''"""A rank named by HOLDS_JAX imports a stub module named jax in its set-up."""
import os
import sys


def setup(ctx):
    if str(ctx.rank) == os.environ["HOLDS_JAX"]:
        sys.path.insert(0, os.environ["STUB_JAX"])
        __import__("jax")


def window(ctx):
    return {}


def profile(ctx):
    pass


def collect(ctx):
    return {}


def check(ctx, outputs):
    return [("nothing", 0.0)]
'''


@pytest.mark.parametrize("holder", ["none", "2"])
def test_a_rank_that_holds_jax_stops_the_line(tmp_path, holder):
    """Rank 2's process holds a module named jax once its part of the run
    is over: the launch exits 2 and prints no line, and says which rank
    held what; with no rank holding it the same cell prints its line."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/drivers/holds_jax.py").write_text(HOLDS_JAX_DRIVER)
    (tmp_path / "benchmark/traffic/holds_jax.json").write_text(json.dumps({"driver": "holds_jax"}))
    (tmp_path / "benchmark/limits/jax.cell.json").write_text("{}")
    spec = harness.load_spec()
    spec["workloads"].append({"name": "jax.cell", "config": "tutorial_8627x20",
                              "traffic": "holds_jax", "chips": 4, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text('"""A stand-in named jax."""\n')
    script = ("import sys\n"
              "from benchmark import harness\n"
              "sys.exit(harness.run_ranks('jax.cell', 1, 1.0, 0, 'cpu', 'gloo', 4, timeout=120))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]), STUB_JAX=str(stub),
               HOLDS_JAX=holder, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=RANKS_TIMEOUT_S)
    if holder == "none":
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
    else:
        assert proc.returncode == 2 and proc.stdout == "", proc.stderr[-3000:]
        assert "rank 2: jax" in proc.stderr


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
    copied harness untouched (a cell on four devices:
    :func:`test_a_mesh_cell_is_added_by_files_and_entries_alone`)."""
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


EXTRA_MESH_METRIC = '''"""The lockstep leaves of rank 0's window."""


def read(record):
    return float(record["counters"].get("leaves", 0)) or None
'''


def test_a_mesh_cell_is_added_by_files_and_entries_alone(tmp_path):
    """The same for a cell with ``chips`` 4: a new configuration, mesh
    traffic mix, limits and per-layer metric, run as four ranks by the
    copied harness untouched."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    config = dict(harness.load_json("configs", "atlas_1Mx50.json"), name="extra_mesh_cfg",
                  **TINY_CONFIG)
    (tmp_path / "benchmark/configs/extra_mesh_cfg.json").write_text(json.dumps(config))
    traffic = dict(harness.load_json("traffic", "nuts_8chains_mesh2x2.json"), chains=4,
                   warmup=60, block_transitions=5)
    (tmp_path / "benchmark/traffic/extra_mesh_mix.json").write_text(json.dumps(traffic))
    limits = harness.load_json("limits", "atlas.nuts4.json")
    (tmp_path / "benchmark/limits/extra.mesh.json").write_text(json.dumps(limits))
    (tmp_path / "benchmark/metrics/extra.leaves.py").write_text(EXTRA_MESH_METRIC)
    spec["configs"].append({"name": "extra_mesh_cfg", "source": "https://example.org/extra",
                            "file": "benchmark/configs/extra_mesh_cfg.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "extra.mesh", "config": "extra_mesh_cfg",
                              "traffic": "extra_mesh_mix", "chips": 4, "why": "a test"})
    harness.find(spec["end_to_end"], "ess_per_s.atlas4", "metric")["workloads"].append(
        "extra.mesh")
    spec["per_layer"].append({"name": "extra.leaves", "unit": "leaves", "better": "higher",
                              "source": "program_counter", "layer": "sampler",
                              "moves": "ess_per_s.atlas4", "workloads": ["extra.mesh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = ("import sys\n"
              "from benchmark import harness\n"
              "assert harness.BENCH.startswith(sys.argv[1])\n"
              "sys.exit(harness.run_ranks('extra.mesh', 11, 1.0, 1, 'cpu', 'gloo', 4))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=RANKS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["metrics"]["extra.leaves"]["value"] >= 1
    assert "nuts.ess_per_draw.atlas4" not in result["metrics"]
    assert len(result["device"]["per_device"]) == 4


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
