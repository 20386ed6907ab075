"""Multi-process runtime helpers on ``torch.distributed``.

Counterpart of ``xva_trainer_tpu/parallel/distributed.py``. JAX brings every
host into one runtime with ``jax.distributed.initialize`` and fans host-0
state out with ``multihost_utils``; here each rank is a process (one card
each, as ``python -m torch.distributed.run`` starts them) and the same jobs
are done by a process group:

- ``initialize_distributed``: NCCL on the card, gloo only where the caller
  asks for the CPU or names gloo. A failed NCCL set-up raises: there is no
  retry over gloo.
- ``broadcast_from_host0``: rank 0's tree of tensors and Python values on
  every rank (the checkpoint fan-out).
- ``global_batch_to_local``: a rank's contiguous slice of the global batch.
- ``make_multihost_mesh``: the ("data", "model") mesh over every rank.

One process with no group is the single-host case: every helper passes its
input through.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

# torchrun's variables, the counterpart of JAX_COORDINATOR_ADDRESS
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """The rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None, backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> bool:
    """Join this process to the job's process group; a no-op (False) for a
    single process that no launcher started.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` set the group up explicitly; otherwise torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` do. The backend is
    ``backend`` when given, gloo when ``device`` is the CPU, else NCCL, with
    this rank on ``cuda:LOCAL_RANK`` (or ``device``). NCCL's communicator is
    made and checked with one all-reduce here, so that a failure raises now.
    Returns True when a group is up."""
    if dist.is_initialized():
        return True
    launched = all(k in os.environ for k in _LAUNCHER_ENV)
    if num_processes in (None, 1) and coordinator_address is None and not launched:
        return False
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rk = int(process_id if process_id is not None else os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend != "nccl":
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rk,
                                timeout=timeout)
        return True
    if not torch.cuda.is_available():
        raise RuntimeError("NCCL needs CUDA, and this host has none; pass device='cpu' "
                           "(or backend='gloo') for a CPU group")
    dev = local_device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init, world_size=world, rank=rk,
                            timeout=timeout, device_id=dev)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"NCCL all-reduce over {world} ranks gave {probe.item()}")
    return True


def make_multihost_mesh(model: int = 1):
    """The global ("data", "model") mesh over every rank: data = world //
    model."""
    from .mesh import make_mesh

    return make_mesh(n_data=world_size() // model, n_model=model)


# ---------------- host-0 fan-out ----------------


_TENSOR = "__tensor__"


def _flatten(tree, tensors: List[torch.Tensor]):
    """The tree with each tensor replaced by (_TENSOR, its index in
    ``tensors``), to which it is appended."""
    if torch.is_tensor(tree):
        tensors.append(tree)
        return (_TENSOR, len(tensors) - 1)
    if isinstance(tree, dict):
        return {k: _flatten(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_flatten(v, tensors) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree


def _unflatten(skel, tensors: List[torch.Tensor]):
    if isinstance(skel, tuple) and len(skel) == 2 and skel[0] == _TENSOR:
        return tensors[skel[1]]
    if isinstance(skel, dict):
        return {k: _unflatten(v, tensors) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, tensors) for v in skel]
    if isinstance(skel, tuple):
        return tuple(_unflatten(v, tensors) for v in skel)
    return skel


def broadcast_from_host0(tree):
    """Rank 0's ``tree`` (dicts, lists and tuples of tensors and picklable
    values, such as a checkpoint's state) on every rank; ``tree`` itself in
    one process. The structure and the Python values go as one pickled
    object; the tensors go as one flat buffer per dtype and home, on the
    card under NCCL. A receiving rank places a tensor that rank 0 held on a
    card on its own card, any other on the CPU. Rank 0 gets its own
    ``tree`` back."""
    if world_size() == 1:
        return tree
    me = dist.get_rank()
    tensors: List[torch.Tensor] = []
    box = [None]
    if me == 0:
        skel = _flatten(tree, tensors)
        box = [(skel, [(tuple(t.shape), t.dtype, t.device.type) for t in tensors])]
    dist.broadcast_object_list(box, src=0)
    skel, specs = box[0]
    card = (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else None)
    nccl = dist.get_backend() == "nccl"
    received: List = [None] * len(specs)
    buckets: Dict[Any, List[int]] = {}
    for i, (_, dtype, home) in enumerate(specs):
        buckets.setdefault((dtype, home), []).append(i)
    for (dtype, home), idx in buckets.items():
        sizes = [int(torch.Size(specs[i][0]).numel()) for i in idx]
        target = card if home == "cuda" else torch.device("cpu")
        wire = card if nccl else target
        if me == 0:
            flat = torch.cat([tensors[i].detach().reshape(-1).to(wire) for i in idx])
        else:
            flat = torch.empty(sum(sizes), dtype=dtype, device=wire)
        if dtype == torch.bool:  # no collective takes bool
            on_wire = flat.to(torch.uint8)
            dist.broadcast(on_wire, src=0)
            flat = on_wire.bool()
        else:
            dist.broadcast(flat, src=0)
        if me != 0:
            for i, piece in zip(idx, torch.split(flat, sizes)):
                received[i] = piece.reshape(specs[i][0]).to(target).clone()
    return tree if me == 0 else _unflatten(skel, received)


def global_batch_to_local(batch: dict, mesh) -> dict:
    """This rank's contiguous slice of a global batch (every array's first
    axis cut into equal slices), by the mesh's data coordinate; ``batch``
    itself with one slice. Other values pass through."""
    count, index = mesh.n_data, mesh.data_index
    if count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1:
            per = v.shape[0] // count
            out[k] = v[index * per:(index + 1) * per]
        else:
            out[k] = v
    return out
