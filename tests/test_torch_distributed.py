"""The port's multi-process helpers (``xva_trainer_tpu_torch/parallel``)
against the JAX package's (``tests/test_distributed.py``): in one process
they pass their input through and the mesh is 1 × 1; over two gloo
processes (spawned as ``tests/test_distributed_multiproc.py`` spawns JAX's,
each with a free port and a time limit) the all-reduce, the host-0 fan-out
and a checkpoint that rank 0 alone read reach both ranks."""
import numpy as np
import pytest
import torch
from torch_dist_common import run_ranks

from xva_trainer_tpu.parallel import distributed as jd
from xva_trainer_tpu.parallel import mesh as jm
from xva_trainer_tpu_torch.parallel import distributed as pd
from xva_trainer_tpu_torch.parallel import mesh as pm


def test_initialize_noop_single_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert pd.initialize_distributed() is False
    jd.initialize_distributed()  # the JAX one is a no-op too
    assert not torch.distributed.is_initialized()


def test_nccl_without_a_card_raises():
    """NCCL is the backend on the card, and there is no quiet gloo instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        pd.initialize_distributed("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_single_process_mesh_and_passthrough():
    mesh = pm.make_mesh()
    assert mesh.axis_names == ("data", "model") == jm.make_mesh().axis_names
    assert mesh.shape == {"data": 1, "model": 1} and mesh.is_main
    assert pd.make_multihost_mesh().shape == {"data": 1, "model": 1}
    tree = {"a": np.ones(3), "b": 2}
    assert pd.broadcast_from_host0(tree) is tree is jd.broadcast_from_host0(tree)
    b = {"x": np.zeros((8, 4)), "n": 3}
    assert pd.global_batch_to_local(b, mesh) is b is jd.global_batch_to_local(b, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert pm.all_gather_rows(t, mesh) is t
    assert pm.commit_replicated(t, mesh) is t
    with pytest.raises(ValueError):
        pm.make_mesh(n_data=2)


def test_shard_batch_single_process():
    mesh = pm.make_mesh()
    batch = {"x": np.arange(6, dtype=np.int32).reshape(3, 2), "y": np.ones(3, np.float32),
             "ids": ["a", "b", "c"]}
    out = pm.shard_batch(mesh, batch, device="cpu")
    assert set(out) == {"x", "y"}  # "ids" stays behind, as in JAX
    assert out["x"].dtype == torch.int64 and np.array_equal(out["x"].numpy(), batch["x"])


@pytest.mark.parametrize("batch_size", [6, 16, 7])
def test_make_mesh_for_batch_divides(batch_size, monkeypatch):
    """JAX's rule over its 8 devices and the port's over 8 ranks (the world
    size stood in for): the largest divisor of the batch that fits."""
    j = jm.make_mesh_for_batch(batch_size)
    assert batch_size % j.shape["data"] == 0
    if batch_size == 16:
        assert j.shape["data"] == 8
    assert pm.make_mesh_for_batch(batch_size).shape == {"data": 1, "model": 1}
    monkeypatch.setattr(pm, "world_size", lambda: 8)
    monkeypatch.setattr(pm, "make_mesh", lambda n_data, n_model: (n_data, n_model))
    assert pm.make_mesh_for_batch(batch_size) == (j.shape["data"], 1)
    assert pm.make_mesh_for_batch(batch_size, n_model=2) == (
        max(d for d in (1, 2, 3, 4) if batch_size % d == 0), 2)


def test_two_process_helpers(tmp_path):
    results = run_ranks("helpers", 2, tmp_path)
    x = np.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(results):
        assert out["rank"] == r and out["world"] == 2
        assert out["all_reduce"] == 3.0  # 1 + 2
        b = out["bcast"]
        assert torch.equal(b["w"], torch.tensor([0.0, 3.0, 6.0, 9.0])) and b["step"] == 7
        assert torch.equal(b["mask"], torch.tensor([True, False]))
        assert b["nested"][0].dtype == torch.float16 and b["nested"][1:] == ["text", None]
        # rank 0's checkpoint, restored on this rank
        ck, disk = out["ckpt"], out["ckpt_on_disk"]
        assert ck["iters"] == 12
        assert all(torch.equal(ck["model"][k], disk["model"][k]) for k in ("a", "b"))
        assert out["mesh"] == ({"data": 2, "model": 1}, r, 0)
        # each rank's contiguous slice, as JAX's global_batch_to_local cuts it
        assert np.array_equal(out["local_x"], x[r * 4:(r + 1) * 4])
        assert out["local_n"] == 3 and out["local_ids"] == list("abcdefgh")
        assert np.array_equal(out["gathered"].numpy(), x)
        assert out["for_batch"] == {4: {"data": 2, "model": 1}, 6: {"data": 2, "model": 1}}
