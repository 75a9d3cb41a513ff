"""The benchmark's CPU tests: the repository's root on the path, and the
program's default device set to the CPU for the tiny runs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny sizes at which a cell runs on the CPU: every width kept small
TINY_CONFIG = {"cells": 1200, "dims": 5, "estimator": {"n_landmarks": 150}}
TINY_TRAFFIC = {"chains": 4, "warmup": 60, "block_transitions": 5, "query_cells": 2000,
                "query_batches": 2, "data_sets": 3, "warmup_fits": 1, "checked_fits": 2}


@pytest.fixture
def cpu_program(monkeypatch):
    """The program with its default device on the CPU."""
    import torch

    import mellon_tpu_torch.config as config

    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return config
