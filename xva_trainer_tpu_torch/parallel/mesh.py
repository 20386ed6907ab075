"""The ("data", "model") mesh over the ranks of a process group.

Counterpart of ``xva_trainer_tpu/parallel/mesh.py``. JAX lays its devices
out as ``reshape(n_data, n_model)`` and lets pjit insert the collectives;
here each rank is one process with one card, rank r sits at
(r // n_model, r % n_model), and the mesh carries one process group per
axis for the steps' own collectives:

- ``data_group``: the ranks of this rank's model coordinate (they hold
  different slices of the batch and the same parameters); gradients are
  summed over it.
- ``model_group``: the ranks of this rank's data coordinate (they hold the
  same slice of the batch and different blocks of the tensor-parallel
  weights, ``parallel/tp.py``).

In one process with no group, ``make_mesh()`` is the 1 × 1 mesh with no
groups, and every function here passes its input through: the trainers run
exactly as without a mesh. ``cpu_init_device``, ``sds_batch`` and
``sds_replicated`` are XLA compile machinery and have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from ..data.prefetch import batch_to_device
from .distributed import global_batch_to_local, rank, world_size


@dataclasses.dataclass
class Mesh:
    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes checkpoints, logs and exports."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh of ``n_data`` × ``n_model`` ranks (``n_data`` defaults to
    every rank over ``n_model``), ranks 0 .. n_data·n_model - 1 laid out as
    JAX's ``reshape(n_data, n_model)``. Every rank of the job must call it,
    in the same order (making a group is a collective); a rank outside the
    mesh raises."""
    world, me = world_size(), rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"a {n_data} × {n_model} mesh does not fit {world} ranks")
    if world == 1:
        return Mesh()
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if me < n_data * n_model and me % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if me < n_data * n_model and me // n_model == d:
            model_group = g
    if me >= n_data * n_model:
        raise ValueError(f"rank {me} is outside the {n_data} × {n_model} mesh")
    return Mesh(n_data, n_model, me, data_group, model_group)


def make_mesh_for_batch(batch_size: int, n_model: int = 1) -> Mesh:
    """The mesh whose data axis is the largest divisor of ``batch_size``
    that fits the ranks (JAX's rule)."""
    max_data = max(1, world_size() // n_model)
    n_data = max(d for d in range(1, max_data + 1) if batch_size % d == 0)
    return make_mesh(n_data=n_data, n_model=n_model)


def shard_batch(mesh: Mesh, batch: dict, device) -> Dict[str, torch.Tensor]:
    """This rank's slice of a collated global batch (by its data
    coordinate), as tensors on ``device``. ``"ids"`` stays behind, as in
    JAX."""
    return batch_to_device(global_batch_to_local(batch, mesh), device)


def commit_replicated(modules_or_tensors, mesh: Mesh):
    """The parameters and buffers (of a module, or a list of modules or
    tensors) of each data group's first rank on every rank of that group,
    in place. A tensor-parallel block is thus broadcast only among the
    ranks that hold the same block."""
    if mesh.n_data == 1:
        return modules_or_tensors
    items = (modules_or_tensors if isinstance(modules_or_tensors, (list, tuple))
             else [modules_or_tensors])
    tensors = []
    for it in items:
        if isinstance(it, nn.Module):
            tensors += list(it.parameters()) + list(it.buffers())
        else:
            tensors.append(it)
    src = dist.get_global_rank(mesh.data_group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh.data_group)
    return modules_or_tensors


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat bucket per dtype
    and device."""
    buckets: Dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, piece in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data group's ``t`` (B_local, ...) stacked by data coordinate into
    (B_local · n_data, ...); ``t`` itself with one data slice. Built from
    an all-reduce, which gloo also runs on CUDA tensors."""
    if mesh.n_data == 1:
        return t
    out = torch.zeros((t.shape[0] * mesh.n_data,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    b = t.shape[0]
    out[mesh.data_index * b:(mesh.data_index + 1) * b] = t
    dist.all_reduce(out, group=mesh.data_group)
    return out


def group_size(group) -> int:
    """The ranks in ``group``; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, with no gradient (a loss's global
    denominator); ``x`` itself for no group."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y
