"""Sampler-state checkpoints (counterpart of
``mellon_tpu/parallel/checkpoint.py``).

A checkpoint is a ``.npz`` of named arrays beside a JSON sidecar of
metadata, the JAX package's format (version :data:`FORMAT_VERSION`): the
chain positions or a state tuple, the adapted step size and mass, the
draws so far, and the random state, so that ``resume_mcmc`` continues a
run as if it had not stopped.

The random state is a ``torch.Generator``'s: its state bytes are stored as
a uint8 array named ``rng_state`` and the sidecar's ``"rng"`` entry says
so, with the generator's device.  The sidecar's ``"device"`` entry names
the device the saved tensors lay on, where the loader puts them back by
default.  A JAX PRNG key cannot cross packages in
either direction: saving one raises, loading a checkpoint that holds one
(``rng_key``, written by ``mellon_tpu``) raises, and ``mellon_tpu``'s
loader finds no ``rng_key`` in the port's checkpoints.

In a run of several ranks (``torch.distributed``), chain-sharded tensors
are gathered across the ranks first, rank 0 writes, as the JAX package's
process 0 does, and every rank then passes a barrier; a rank loads onto
its own CUDA device.
"""

import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from .mesh import check_sharding

logger = logging.getLogger("mellon_tpu_torch")

FORMAT_VERSION = 2
RNG_KIND = "torch.Generator"

_JAX_KEY = (
    "a JAX PRNG key cannot be used by mellon_tpu_torch's samplers, which "
    "draw from a torch.Generator; pass the generator (or seed a new one)."
)


def _base_path(path):
    """'<base>.npz' holds the arrays and '<base>.json' the metadata,
    whether ``path`` is the base or the full .npz name."""
    base = str(path)
    return base[: -len(".npz")] if base.endswith(".npz") else base


def _is_jax(value):
    return type(value).__module__.split(".")[0] in ("jax", "jaxlib")


def _to_numpy(name, value):
    if _is_jax(value):
        raise TypeError(f"{name}: {_JAX_KEY}" if name == "rng_key" else
                        f"{name} is a JAX array; hand mellon_tpu_torch tensors.")
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten(state):
    """The leaves of a (named) tuple or list of tensors, depth first, None
    skipped (the order ``jax.tree.flatten`` gives)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for item in state for leaf in _flatten(item)]
    return [state]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, (tuple, list)):
        items = [_unflatten(item, leaves) for item in template]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    return next(leaves)


def save_sampler_state(path, *, samples=None, state=None, step_size=None,
                       inv_mass_diag=None, rng_key=None, metadata=None, chain_sharding=None):
    """Write a sampler checkpoint to ``<base>.npz`` and ``<base>.json``.

    ``state`` is a tensor or a (named) tuple or list of them (an
    ``HMCState``, say); ``rng_key`` is the ``torch.Generator`` the run
    draws from.  A JAX key raises TypeError.

    With ``chain_sharding`` (a sharding of :mod:`.mesh`), ``samples`` and
    the leaves of ``state`` are this rank's block of the chains and are
    gathered in chain order.  When a process group is initialized every
    rank must call this; rank 0 writes (its generator's state) and all
    ranks wait at a barrier until the files are complete.
    """
    sharding = check_sharding(chain_sharding, "chain_sharding")
    if sharding is not None:
        gather = sharding.gather
        samples = None if samples is None else gather(samples)
        state = None if state is None else [gather(leaf) for leaf in _flatten(state)]
    if dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return
    arrays = {}
    meta = {"format_version": FORMAT_VERSION}

    def put(name, value):
        if value is not None:
            arrays[name] = _to_numpy(name, value)
            if isinstance(value, torch.Tensor):
                meta.setdefault("device", str(value.device))

    put("step_size", step_size)
    put("inv_mass_diag", inv_mass_diag)
    put("samples", samples)
    if state is not None:
        leaves = _flatten(state)
        for i, leaf in enumerate(leaves):
            put(f"state_{i}", leaf)
        arrays["_state_num_leaves"] = np.asarray(len(leaves))
    if rng_key is not None:
        if not isinstance(rng_key, torch.Generator):
            raise TypeError(f"rng_key: {_JAX_KEY}")
        arrays["rng_state"] = rng_key.get_state().numpy()
        meta["rng"] = {"kind": RNG_KIND, "device": str(rng_key.device)}
        meta.setdefault("device", str(rng_key.device))
    if metadata:
        meta.update(metadata)
    base = _base_path(path)
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(meta, f)
    logger.info("Wrote sampler checkpoint to %s.npz.", base)
    if dist.is_initialized():
        dist.barrier()


def load_sampler_state(path, state_template=None, device=None):
    """Load a checkpoint written by :func:`save_sampler_state`.

    Returns a dict with keys among {samples, state, step_size,
    inv_mass_diag, rng_key, metadata}: tensors on ``device``, by default
    the device they were saved from (``config.DEFAULT_DEVICE`` where the
    sidecar names none, as in a mellon_tpu checkpoint), ``state`` in
    ``state_template``'s structure where one is given (else a list of its
    leaves), and ``rng_key`` a ``torch.Generator`` in the saved state, on
    ``device`` or else the device it was saved from.  In a run of several
    ranks, a checkpoint saved from a CUDA device loads by default onto the
    calling rank's current CUDA device.  A checkpoint that holds a JAX key
    raises ValueError.
    """
    base = _base_path(path)
    data = np.load(base + ".npz")
    metadata = None
    meta_path = base + ".json"
    if not os.path.exists(meta_path) and os.path.exists(str(path) + ".json"):
        # the sidecar of checkpoints written before path normalization
        meta_path = str(path) + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    if "rng_key" in data or (metadata or {}).get("prng_impls"):
        raise ValueError(f"{path} holds a JAX PRNG key (written by mellon_tpu): {_JAX_KEY}")

    saved_on = (metadata or {}).get("device", config.DEFAULT_DEVICE)
    if dist.is_initialized() and torch.device(saved_on).type == "cuda":
        saved_on = f"cuda:{torch.cuda.current_device()}"

    def get(name):
        return torch.as_tensor(data[name], device=saved_on if device is None else device)

    out = {}
    for key in ("step_size", "inv_mass_diag", "samples"):
        if key in data:
            out[key] = get(key)
    if "rng_state" in data:
        rng = (metadata or {}).get("rng", {})
        if rng.get("kind") != RNG_KIND:
            raise ValueError(f"{path}: the random state's kind {rng.get('kind')!r} is unknown.")
        rng_device = rng["device"]
        if dist.is_initialized() and torch.device(rng_device).type == "cuda":
            rng_device = saved_on
        generator = torch.Generator(device=rng_device if device is None else device)
        generator.set_state(torch.as_tensor(data["rng_state"]))
        out["rng_key"] = generator
    if "_state_num_leaves" in data:
        leaves = [get(f"state_{i}") for i in range(int(data["_state_num_leaves"]))]
        out["state"] = leaves if state_template is None else _unflatten(state_template, iter(leaves))
    if metadata is not None:
        out["metadata"] = metadata
    return out
