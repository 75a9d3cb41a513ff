"""``chip_smoke.py``'s operand recorder on the CPU.

The script holds the covariance module's Matern-5/2 calls, recorded above
the wrapper, to the wrapper's own launch count: the two agree only where
every call launched the kernel on the card.  A call that took the plain
version on the CPU is recorded without a launch and named as a host call;
a replayed graph adds the calls made while it was captured to the
recording and their launches to the count.
"""

import torch

import chip_smoke
from mellon_tpu_torch.ops import hopper_kernels, kernels


def test_host_call_is_recorded_without_a_launch():
    x = torch.randn(7, 3, dtype=torch.float64)
    before = kernels.matern52_gram
    hopper_kernels.matern52_gram.launches = 0
    calls, stop = chip_smoke.record_operands()
    try:
        kernels.Matern52(1.5)(x, x[:4])
    finally:
        stop()
    assert len(calls) == 1 and hopper_kernels.matern52_gram.launches == 0
    assert len(chip_smoke.host_calls(calls)) == 1
    assert kernels.matern52_gram is before and not chip_smoke._WRAPPED


def test_replay_adds_the_captured_calls_and_their_launches():
    graph = [object(), object()]  # a graph's list of captured launches
    captured = [(torch.zeros(3, 2), torch.zeros(4, 2), 1.0)]
    chip_smoke._GRAPH_CALLS[id(graph)] = (graph, captured)
    hopper_kernels.matern52_gram.launches = 0
    calls, stop = chip_smoke.record_operands()
    try:
        hopper_kernels.count_replay(graph)
        hopper_kernels.count_replay(graph)
    finally:
        stop()
        del chip_smoke._GRAPH_CALLS[id(graph)]
    assert calls == captured * 2
    assert hopper_kernels.matern52_gram.launches == 2 * len(graph)
