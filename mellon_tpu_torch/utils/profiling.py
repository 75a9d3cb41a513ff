"""Phase timers and device tracing (counterpart of
``mellon_tpu/utils/profiling.py``).

* :class:`PhaseTimer`: named wall-clock phases whose end waits for the
  device of the tensors handed to the phase (``torch.cuda.synchronize`` on
  each CUDA device among them), collected into a report;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace into a directory.
"""

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("mellon_tpu_torch")


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
        """Time a phase; the clock stops once the CUDA devices of
        ``sync_tensors`` are done (otherwise asynchronous launches hide
        the device time).  Other values are ignored."""
        t0 = time.perf_counter()
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
    ``<log_dir>/trace.json``; yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote profiler trace to %s.", path)
