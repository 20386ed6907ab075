"""Rank processes for the port's data- and tensor-parallel CPU tests (not a
test module): ``run_ranks`` starts ``world`` processes of this file over a
gloo group on a free local port, each with a time limit, and returns what
each rank saved. The tasks import torch and the port only (no JAX), read
their inputs from ``inputs.pt`` in the work directory and write
``out_<rank>.pt`` there.

    python tests/torch_dist_common.py TASK RANK WORLD PORT WORKDIR
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, workdir, inputs=None, timeout: float = 240.0):
    """Run ``task`` on ``world`` gloo ranks; every rank must exit 0 within
    ``timeout`` seconds (the others are killed when one fails or hangs).
    Returns the ranks' saved outputs, by rank."""
    workdir = str(workdir)
    if inputs is not None:
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), str(port),
                               workdir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None):
                break  # a rank failed: the others would wait for it
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    errors = []
    for r, p in enumerate(procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"rank {r} of {task} exited {p.returncode}:\n{err.decode()[-3000:]}")
    assert not errors, "\n".join(errors)
    outs = []
    for r in range(world):  # read, then removed: the states run to gigabytes
        path = os.path.join(workdir, f"out_{r}.pt")
        outs.append(torch.load(path, weights_only=False))
        os.remove(path)
    if inputs is not None:
        os.remove(os.path.join(workdir, "inputs.pt"))
    return outs


class Sgd:
    """``optax.sgd`` in the port's optimiser interface (as
    ``tests/torch_v3_common.py::Sgd``, without JAX)."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0):
        self.params, self.lr, self.wd = list(params), lr, weight_decay

    @torch.no_grad()
    def step(self, grads, apply_mask=None):
        for i, (p, g) in enumerate(zip(self.params, grads)):
            u = -self.lr * ((0 if g is None else g) + self.wd * p)
            if apply_mask is None or apply_mask[i]:
                p.add_(u)
        return True


def numpy_meta(meta):
    return {k: v.detach().double().numpy() for k, v in meta.items()}


def state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ---------------- the v3 step ----------------


def v3_models(inp):
    from xva_trainer_tpu_torch.models.xvapitch import (VitsDiscriminator, XVAPitch,
                                                       XVAPitchConfig)

    dtype = inp.get("dtype", torch.float32)
    model = XVAPitch(XVAPitchConfig(**inp["cfg"])).to(dtype)
    model.load_state_dict(inp["g_sd"], strict=True)
    disc = VitsDiscriminator().to(dtype)
    disc.load_state_dict(inp["d_sd"], strict=True)
    model.train(inp["train_mode"])
    disc.train(inp["train_mode"])
    return model, disc


def run_v3(inp, mesh=None):
    """One micro-step of ``make_v3_step`` (fp32, SGD) per global batch of
    ``inp["batches"]``, this rank's slice under ``mesh``. Returns the metas and
    the models' states after."""
    from xva_trainer_tpu_torch.parallel.mesh import shard_batch
    from xva_trainer_tpu_torch.data.prefetch import batch_to_device
    from xva_trainer_tpu_torch.train.xvapitch_trainer import make_v3_step

    model, disc = v3_models(inp)
    step = make_v3_step(model, disc, Sgd(model.parameters(), inp["lr"]),
                        Sgd(disc.parameters(), inp["lr"]), freeze_post_dec=False,
                        use_amp=False, mesh=mesh)
    gen = torch.Generator().manual_seed(inp["seed"])
    metas = []
    for b, draws in zip(inp["batches"], inp["draws"]):
        dev = batch_to_device(b, "cpu") if mesh is None else shard_batch(mesh, b, "cpu")
        metas.append(numpy_meta(step(dev, gen, **(draws or {}))))
    return {"metas": metas, "g": state(model), "d": state(disc)}


def run_v3_f64(inp):
    """``run_v3`` in float64, one process: the models, the batches (the audio
    dequantised) and the draws in float64, and every ``Tensor.float()`` of a
    float64 tensor kept in float64 while it runs (the STFT's constants as
    the fp32 step rounds them, then widened). The witness of what the fp32
    steps compute in exact arithmetic."""
    import xva_trainer_tpu_torch.ops.fused_stft as fused_stft
    import xva_trainer_tpu_torch.ops.stft as stft

    to_float, constant = torch.Tensor.float, stft.device_constant

    def keep64(self, *a, **k):
        return self if self.dtype == torch.float64 else to_float(self, *a, **k)

    def constant64(fn, args, device):
        t = constant(fn, args, device)
        return t.double() if t.is_floating_point() else t

    def wide(sd):
        return {k: (v.double() if v.is_floating_point() else v) for k, v in sd.items()}

    def wide_batch(b):
        b = dict(b)
        b["wav"] = b["wav"].astype(np.float64) / 32767.0
        for k in ("pitch", "energy", "dvec"):
            b[k] = b[k].astype(np.float64)
        return b

    inp = dict(inp, dtype=torch.float64, g_sd=wide(inp["g_sd"]), d_sd=wide(inp["d_sd"]),
               batches=[wide_batch(b) for b in inp["batches"]],
               draws=[d and {k: v.double() for k, v in d.items()} for d in inp["draws"]])
    torch.Tensor.float = keep64
    stft.device_constant = fused_stft.device_constant = constant64
    try:
        return run_v3(inp)
    finally:
        torch.Tensor.float = to_float
        stft.device_constant = fused_stft.device_constant = constant


def task_dp(rank, world, workdir, inp):
    """Every v3 case and the FastPitch case on a data mesh of ``world``."""
    from xva_trainer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=world)
    return {"v3": {name: run_v3(case, mesh) for name, case in inp["v3"].items()},
            "fastpitch": inp["fastpitch"] and run_fastpitch(inp["fastpitch"], mesh)}


# ---------------- FastPitch's stage step, data x model ----------------


def fastpitch_batch(b):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    out = {k: (v.long() if v.dtype == torch.int32 else v) for k, v in out.items()}
    out["all_aligned"] = bool(np.all(b["mel_lens"] >= b["in_lens"]))
    return out


def run_fastpitch(inp, mesh=None):
    """``make_stage_step`` micro-steps with LAMB on the global batches (this
    rank's slice under ``mesh``; the FFNs cut over its model axis when it
    has one). Returns the metas and the whole parameters after."""
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch, FastPitchConfig
    from xva_trainer_tpu_torch.parallel.distributed import global_batch_to_local
    from xva_trainer_tpu_torch.parallel.tp import (FASTPITCH_TP_RULES, gather_params,
                                                   shard_params, sharding_summary)
    from xva_trainer_tpu_torch.train import fastpitch_trainer as pft
    from xva_trainer_tpu_torch.train.optim import LambOptimizer, fastpitch_stage_mask

    model = FastPitch(FastPitchConfig(**inp["cfg"]))
    model.load_state_dict(inp["sd"], strict=True)
    model.train()
    if mesh is not None and mesh.n_model > 1:
        shard_params(model, mesh, FASTPITCH_TP_RULES)
    stage = inp["stage"]
    opt = LambOptimizer(model.parameters(), 0.1, 1e-6, inp["warmup"],
                        grad_accum=len(inp["batches"]),
                        train_mask=fastpitch_stage_mask(model, stage))
    step = pft.make_stage_step(model, stage, opt, use_amp=False, device_prior=True, mesh=mesh)
    gen = torch.Generator().manual_seed(inp["seed"])
    metas = []
    for b in inp["batches"]:
        local = b if mesh is None else global_batch_to_local(b, mesh)
        metas.append(numpy_meta(step(fastpitch_batch(local), 0.0, gen)))
    params = gather_params(model, mesh) if mesh is not None else {
        k: v.detach().clone() for k, v in model.named_parameters()}
    return {"metas": metas, "params": params, "summary": sharding_summary(model),
            "local_shapes": {k: tuple(v.shape) for k, v in model.named_parameters()}}


# ---------------- xVAPitch's FFN, tensor-parallel with dropout ----------------


def run_rpt(inp, mesh=None):
    """A RelativePositionTransformer in training mode (dropout 0.5): its
    output and the input's gradient, this rank's rows under ``mesh`` (its
    FFNs cut over the model axis)."""
    from xva_trainer_tpu_torch.models.xvapitch.layers import RelativePositionTransformer
    from xva_trainer_tpu_torch.parallel.draws import shard_draws
    from xva_trainer_tpu_torch.parallel.tp import XVAPITCH_TP_RULES, shard_params

    torch.manual_seed(0)
    m = RelativePositionTransformer(32, 32, 64, 2, 2, dropout_p=0.5).train()
    x, mask, w = (torch.from_numpy(inp[k]) for k in ("x", "mask", "w"))
    gen = torch.Generator().manual_seed(5)
    if mesh is not None:
        shard_params(m, mesh, XVAPITCH_TP_RULES)
        b = x.shape[0] // mesh.n_data
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        x, mask, w = x[rows], mask[rows], w[rows]
        gen = shard_draws(gen, mesh.data_index, mesh.n_data)
    x = x.clone().requires_grad_(True)
    y = m(x, mask, gen)
    (y * w).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad}


def task_tp(rank, world, workdir, inp):
    from xva_trainer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=2, n_model=2)
    return {"fastpitch": run_fastpitch(inp["fastpitch"], mesh), "rpt": run_rpt(inp["rpt"], mesh),
            "coords": (mesh.data_index, mesh.model_index)}


# ---------------- the helpers ----------------


def task_helpers(rank, world, workdir, inp):
    import torch.distributed as dist

    from xva_trainer_tpu_torch.parallel import distributed as pd
    from xva_trainer_tpu_torch.parallel.mesh import (all_gather_rows, make_mesh,
                                                     make_mesh_for_batch)

    out = {"rank": pd.rank(), "world": pd.world_size()}
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    out["all_reduce"] = float(t)
    tree = ({"w": torch.arange(4.0) * 3, "step": 7, "mask": torch.tensor([True, False]),
             "nested": [torch.ones(2, 3, dtype=torch.float16), "text", None]}
            if rank == 0 else None)
    out["bcast"] = pd.broadcast_from_host0(tree)
    # rank 0's checkpoint, read on rank 0 only and fanned out
    path = os.path.join(workdir, "ckpt.pt")
    if rank == 0:
        torch.save({"model": {"a": torch.randn(3, 5), "b": torch.arange(6)}, "iters": 12}, path)
    dist.barrier()
    ckpt = torch.load(path, weights_only=False) if rank == 0 else None
    out["ckpt"] = pd.broadcast_from_host0(ckpt)
    out["ckpt_on_disk"] = torch.load(path, weights_only=False)
    mesh = make_mesh()
    out["mesh"] = (mesh.shape, mesh.data_index, mesh.model_index)
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "n": 3, "ids": list("abcdefgh")}
    local = pd.global_batch_to_local(batch, mesh)
    out["local_x"], out["local_n"], out["local_ids"] = local["x"], local["n"], local["ids"]
    out["gathered"] = all_gather_rows(torch.from_numpy(local["x"]).float(), mesh)
    out["for_batch"] = {bs: make_mesh_for_batch(bs).shape for bs in (4, 6)}
    return out


TASKS = {"dp": task_dp, "tp": task_tp, "helpers": task_helpers}


def main(argv):
    task, rank, world, port, workdir = argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5]
    torch.set_num_threads(1)
    from xva_trainer_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
    path = os.path.join(workdir, "inputs.pt")
    inp = torch.load(path, weights_only=False) if os.path.exists(path) else None
    out = TASKS[task](rank, world, workdir, inp)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
