"""The tutorials on mellon_tpu_torch (``examples/*_tutorial_torch.py``) run
to their end on the CPU, with ``config.DEFAULT_DEVICE`` set to "cpu" (on
the card they run in ``chip_smoke.py``'s ``[tutorials]``).  Each runs its
own asserts (the dense population above the rare one, the JSON and dict
round trips within 1e-6, the gene trends within 0.1 RMSE of the truth).
The time-series tutorial is left to the card: it takes ~90 s here with
two threads, past this suite's budget for one test.
"""

import runpy
from pathlib import Path

import pytest

import _torch_parity  # noqa: F401  (two torch threads per test worker)
import mellon_tpu_torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.mark.parametrize("name", ["basic", "gene_change_analysis", "trajectory_trends"])
def test_tutorial_runs_on_cpu(name, monkeypatch, capsys):
    monkeypatch.setattr(mellon_tpu_torch.config, "DEFAULT_DEVICE", "cpu")
    runpy.run_path(str(EXAMPLES / f"{name}_tutorial_torch.py"), run_name="__main__")
    assert "tutorial flow complete" in capsys.readouterr().out
