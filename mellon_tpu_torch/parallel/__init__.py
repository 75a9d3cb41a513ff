"""Sampler checkpoints (counterpart of ``mellon_tpu/parallel``).  The
mesh and the chain and cell sharding across GPUs are ROADMAP Queue 1
item 17."""

from .checkpoint import FORMAT_VERSION, load_sampler_state, save_sampler_state

__all__ = ["FORMAT_VERSION", "load_sampler_state", "save_sampler_state"]
