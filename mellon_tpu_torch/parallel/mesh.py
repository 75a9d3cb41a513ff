"""The (chains, cells) mesh over ``torch.distributed`` (counterpart of
``mellon_tpu/parallel/mesh.py``).

The JAX package runs one program over global arrays and lets GSPMD insert
the collectives.  Here every process is one rank on one device and holds
its block of each sharded tensor; the collectives are written out, in
:mod:`.sharding` and the samplers, through the helpers at the end of this
module.  The mesh has the JAX package's two axes:

* ``chains``: MCMC chains and SMC particles, split in blocks over ranks;
* ``cells``: the rows of the n×m matrix L and the per-cell likelihood
  terms, whose sum is an ``all_reduce`` over the ranks of one chain block.

Rank r sits at (r // n_cells, r % n_cells), the JAX package's
``devices.reshape(n_chains, n_cells)``.  A sharding is a small descriptor
(:class:`Sharding`): the mesh and the axis that splits a tensor's leading
dimension, or none.  Without an initialized process group the mesh is one
rank, and every collective is the identity.
"""

import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import config

logger = logging.getLogger("mellon_tpu_torch")

CHAIN_AXIS = "chains"
CELL_AXIS = "cells"
AXES = (CHAIN_AXIS, CELL_AXIS)


def distributed_initialize(backend=None, device=None, **kwargs):
    """Join the process group of this run (one process per GPU, as
    ``torchrun`` starts them): ``torch.distributed.init_process_group``
    with ``backend`` and ``kwargs``.  ``backend=None`` takes "nccl" for
    ranks on CUDA and "gloo" for ranks on the CPU, by ``device``
    (``config.DEFAULT_DEVICE`` if None); a CUDA rank's current device is
    set first, to ``device`` or, without an index, ``cuda:<LOCAL_RANK>``.
    Safe to call when a group already exists: it logs and returns."""
    if dist.is_initialized():
        logger.info("torch.distributed already initialized: rank %d / %d",
                    dist.get_rank(), dist.get_world_size())
        return
    device = _local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), **kwargs)
    logger.info("torch.distributed initialized: rank %d / %d (%s)",
                dist.get_rank(), dist.get_world_size(), dist.get_backend())


def _local_device(device):
    """``device`` (``config.DEFAULT_DEVICE`` if None), a CUDA device without
    an index made ``cuda:<LOCAL_RANK>``."""
    device = torch.device(config.DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def mesh_shape(n_chains, n_cells, n_devices):
    """``(n_chains, n_cells)`` over ``n_devices`` with the JAX package's
    defaults: all devices on the chains axis, or the other axis filled."""
    if n_chains is None and n_cells is None:
        n_chains, n_cells = n_devices, 1
    elif n_chains is None:
        n_chains = n_devices // n_cells
    elif n_cells is None:
        n_cells = n_devices // n_chains
    if n_chains * n_cells != n_devices:
        raise ValueError(f"Mesh {n_chains}x{n_cells} does not match {n_devices} devices.")
    return n_chains, n_cells


class Mesh:
    """A (chains, cells) mesh seen from one rank: ``shape`` maps each axis
    to its size (as a JAX ``Mesh.shape`` does), ``coords`` to this rank's
    index on it, ``groups`` to the process group of the ranks that differ
    from this one only along it (None without a process group), and
    ``device`` is where this rank's tensors live."""

    axis_names = AXES

    def __init__(self, n_chains, n_cells, rank, device, groups):
        self.shape = {CHAIN_AXIS: n_chains, CELL_AXIS: n_cells}
        self.size = n_chains * n_cells
        self.rank = rank
        self.coords = {CHAIN_AXIS: rank // n_cells, CELL_AXIS: rank % n_cells}
        self.device = device
        self.groups = groups

    def __repr__(self):
        return (f"Mesh({self.shape[CHAIN_AXIS]}x{self.shape[CELL_AXIS]}, rank {self.rank} at "
                f"{self.coords}, {self.device})")


def create_mesh(n_chains=None, n_cells=None, devices=None):
    """Create a (chains, cells) mesh over the ranks of the process group.

    With ``n_chains=None`` every rank goes to the chain axis; with both
    given their product must equal the number of ranks.  ``devices`` is
    one device per rank (this rank takes ``devices[rank]``); by default a
    rank runs on ``cuda:<LOCAL_RANK>``, or on ``config.DEFAULT_DEVICE``
    where that is not "cuda".  Every rank must call this, in the same
    order as its other group creations.
    """
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n_devices = world if devices is None else len(devices)
    n_chains, n_cells = mesh_shape(n_chains, n_cells, n_devices)
    if n_devices != world:
        raise ValueError(f"{n_devices} devices were given for {world} ranks: one per rank.")
    device = _local_device(None if devices is None else devices[rank])
    groups = {CHAIN_AXIS: None, CELL_AXIS: None}
    if initialized:
        # every rank creates every group, in one order
        for c in range(n_cells):
            g = dist.new_group([i * n_cells + c for i in range(n_chains)])
            if rank % n_cells == c:
                groups[CHAIN_AXIS] = g
        for i in range(n_chains):
            g = dist.new_group([i * n_cells + c for c in range(n_cells)])
            if rank // n_cells == i:
                groups[CELL_AXIS] = g
    return Mesh(n_chains, n_cells, rank, device, groups)


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: its leading dimension split in blocks
    over the ranks of ``axis``, in rank order (``None``: every rank holds
    all of it)."""

    mesh: Mesh
    axis: str = None
    ndim: int = 1

    @property
    def size(self):
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    @property
    def index(self):
        return 0 if self.axis is None else self.mesh.coords[self.axis]

    @property
    def group(self):
        return None if self.axis is None else self.mesh.groups[self.axis]

    def block(self, total):
        """This rank's ``(start, stop)`` of ``total`` leading rows: blocks
        of ⌊total / size⌋ or ⌈total / size⌉ rows, in rank order."""
        return self.index * total // self.size, (self.index + 1) * total // self.size

    def shard(self, t):
        """This rank's block of the global tensor ``t``, a copy on the
        mesh's device (the global tensor can be released)."""
        lo, hi = self.block(t.shape[0])
        return t[lo:hi].to(self.mesh.device, copy=True)

    def gather(self, t):
        """The global tensor from every rank's block ``t`` (blocks of
        equal size), on every rank."""
        return all_gather(t, self.group, self.size)

    def mean(self, values, total):
        """The mean over all ``total`` rows of every rank's block ``values``."""
        return all_reduce_sum(values.sum(), self.group) / total


def sampling_block(sharding, rows, draws, what):
    """The samplers' chains or SMC's particles split under ``sharding`` (one
    rank that holds them all where it is None): returns the sharding, this
    rank's block of the global ``rows`` and a source that keeps that
    block's draws (``draws.chain_block``).  ValueError unless the rows
    (``what``) split in equal blocks, which :meth:`Sharding.gather` needs."""
    sharding = Sharding(None) if sharding is None else sharding
    total = rows.shape[0]
    if total % sharding.size:
        raise ValueError(
            f"{total} {what} do not divide over the {sharding.size} ranks of the "
            f"{sharding.axis} axis."
        )
    if sharding.group is None:
        return sharding, rows, draws
    start, stop = sharding.block(total)
    return sharding, rows[start:stop], draws.chain_block(start, stop, total)


def cell_sharding(mesh, ndim=1):
    """A tensor's leading (cells) axis split over the mesh's cells axis."""
    return Sharding(mesh, CELL_AXIS, ndim)


def chain_sharding(mesh):
    """A tensor's leading (chains) axis split over the mesh's chains axis."""
    return Sharding(mesh, CHAIN_AXIS)


def replicated(mesh):
    return Sharding(mesh, None)


def check_sharding(value, name):
    """``value`` if it is a :class:`Sharding` (or None), else TypeError."""
    if value is not None and not isinstance(value, Sharding):
        raise TypeError(
            f"{name} must be a sharding of mellon_tpu_torch.parallel (chain_sharding(mesh), "
            f"cell_sharding(mesh) or replicated(mesh)), got {type(value).__name__}."
        )
    return value


# ---------------------------------------------------------------------------
# collectives over one axis's group; the identity without a process group
# ---------------------------------------------------------------------------


def all_reduce_sum(t, group):
    """The elementwise sum of ``t`` over the ranks of ``group`` (in place)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast_from_first_rank(t):
    """Rank 0's ``t`` on every rank of the process group (in place); the
    identity without one."""
    if dist.is_initialized():
        dist.broadcast(t, src=0)
    return t


def all_gather(t, group, size):
    """The blocks ``t`` of the ``size`` ranks of ``group``, concatenated
    along the leading axis in rank order."""
    if group is None:
        return t
    is_bool = t.dtype == torch.bool
    t = (t.to(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if is_bool else out

