"""Tensor parallelism in the port (``xva_trainer_tpu_torch/parallel/tp.py``)
against the JAX package's (``tests/test_tp.py``).

- The rules cut exactly the FFN weights that JAX's rules shard, on the same
  axes (a flax conv kernel is (k, in, out), a torch conv weight (out, in,
  k)), on FastPitch and on xVAPitch's ``RelativePositionTransformer``; a
  filter size that does not divide the model axis stays replicated.
- A data 2 × model 2 gloo run (four processes) of FastPitch's stage-4 step
  with LAMB (two micro-steps of one update, dropout 0.1) against the
  replicated one-process step on the same global batch: the losses within
  1e-3 relative (``tests/test_tp.py``'s bar), and the blocks reassembled
  equal to the replicated parameters within 1e-5 of each tensor's max abs.
- xVAPitch's FFN cut over the model axis in a transformer with dropout 0.5:
  each rank's output and input gradient within 1e-5 of the replicated
  run's rows (the hidden's dropout takes its channels of the replicated
  mask).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_common import run_fastpitch, run_ranks, run_rpt
from torch_v3_common import _seeded

from xva_trainer_tpu.models.fastpitch import FastPitch as JaxFastPitch
from xva_trainer_tpu.models.fastpitch import FastPitchConfig as JaxFastPitchConfig
from xva_trainer_tpu.models.xvapitch.layers import RelativePositionTransformer as JaxRPT
from xva_trainer_tpu.parallel import tp as jtp
from xva_trainer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xva_trainer_tpu_torch.models.fastpitch import FastPitch, FastPitchConfig
from xva_trainer_tpu_torch.models.xvapitch.layers import RelativePositionTransformer
from xva_trainer_tpu_torch.parallel import tp
from xva_trainer_tpu_torch.parallel.mesh import Mesh

B, T_TEXT, T_MEL = 8, 16, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fp_kw(ffn=64, dropout=0.0):
    return dict(symbols_embedding_dim=64, in_fft_n_layers=1, out_fft_n_layers=1,
                in_fft_d_head=32, out_fft_d_head=32, in_fft_filter_size=ffn,
                out_fft_filter_size=ffn, predictor_filter_size=32, p_fft_dropout=dropout,
                p_fft_dropatt=0.0, p_predictor_dropout=0.0)


def jax_fp_params(ffn):
    z = jnp.zeros
    shapes = jax.eval_shape(
        JaxFastPitch(JaxFastPitchConfig(**fp_kw(ffn))).init, jax.random.PRNGKey(0),
        z((1, T_TEXT), jnp.int32), jnp.ones((1,), jnp.int32), z((1, T_MEL, 80)),
        jnp.ones((1,), jnp.int32), z((1, 1, T_MEL)), z((1, T_MEL)), z((1, T_MEL, T_TEXT)))
    return _seeded(shapes, 0)


# flax kernel (k, in, out) axis → torch weight (out, in, k) axis; biases keep 0
KERNEL_AXIS = {2: 0, 1: 1, 0: 2}


def jax_cuts(sharded, pattern):
    """{(stack, layer, conv, kind): the cut torch axis} of JAX's placed
    parameters."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        m = re.search(pattern, "/".join(str(getattr(k, "key", k)) for k in path))
        spec = tuple(leaf.sharding.spec)
        if m and "model" in spec:
            axis = spec.index("model")
            out[m.groups()] = KERNEL_AXIS[axis] if m.groups()[-1] == "kernel" else axis
    return out


def port_cuts(model, pattern):
    out = {}
    for name, p in model.named_parameters():
        spec = getattr(p, "tp_spec", ())
        m = re.search(pattern, name)
        if spec and m:
            g = m.groups()
            out[g[:-1] + ("kernel" if g[-1] == "weight" else "bias",)] = spec.index("model")
    return out


FP_JAX = r"(encoder|decoder)/ff_layers_(\d+)/Conv1d_(\d)/Conv_0/(kernel|bias)"
FP_PORT = r"(encoder|decoder)\.layers\.(\d+)\.pos_ff\.CoreNet\.(\d)\.(weight|bias)"


def _fp_conv_index(cuts):
    """CoreNet.0/.2 → flax's Conv1d_0/_1."""
    return {(s, layer, {"0": "0", "2": "1"}[c], kind): ax for (s, layer, c, kind), ax in cuts.items()}


@pytest.mark.parametrize("ffn", [64, 66, 33])
def test_fastpitch_rules_cut_what_jax_shards(ffn):
    params = jax_fp_params(ffn)
    mesh = jax_make_mesh(n_data=4, n_model=2)
    with mesh:
        sharded = jtp.shard_params(params, mesh, jtp.FASTPITCH_TP_RULES)
    expect = jax_cuts(sharded, FP_JAX)
    assert bool(expect) == bool(jtp.sharding_summary(sharded, mesh))
    model = FastPitch(FastPitchConfig(**fp_kw(ffn)))
    tp.shard_params(model, Mesh(n_data=4, n_model=2), tp.FASTPITCH_TP_RULES)
    got = _fp_conv_index(port_cuts(model, FP_PORT))
    assert got == expect
    if ffn == 33:  # 33 does not divide the model axis: replicated
        assert not got and not tp.sharding_summary(model)
        assert type(model.encoder.layers[0].pos_ff) is not tp.TPPositionwiseConvFF
    else:
        # both stacks; the first conv and its bias on the output channels,
        # the second on its input channels
        assert len(got) == 6
        w = dict(model.named_parameters())["decoder.layers.0.pos_ff.CoreNet.0.weight"]
        assert w.shape[0] == ffn // 2
        assert type(model.decoder.layers[0].pos_ff) is tp.TPPositionwiseConvFF


def test_xvapitch_rules_match_jax():
    m = JaxRPT(in_channels=32, hidden_channels=32, out_channels=32, hidden_channels_ffn=64,
               num_heads=2, num_layers=2)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 32)),
                            jnp.ones((1, 8, 1)))
    specs = jtp.tp_pspecs(shapes, jtp.XVAPITCH_TP_RULES)
    jax_cut = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        mm = re.search(r"FeedForwardNetwork_(\d+)/Conv_(\d)/(kernel|bias)", key)
        if mm and s != jax.sharding.PartitionSpec():
            ax = tuple(s).index("model")
            jax_cut[mm.groups()] = KERNEL_AXIS[ax] if mm.group(3) == "kernel" else ax
    port = RelativePositionTransformer(32, 32, 64, 2, 2)
    ours = {}
    for name, spec in tp.tp_pspecs(port, tp.XVAPITCH_TP_RULES).items():
        mm = re.search(r"ffn_layers\.(\d+)\.conv_(\d)\.(weight|bias)", name)
        if mm and spec:
            key = (mm.group(1), str(int(mm.group(2)) - 1),
                   "kernel" if mm.group(3) == "weight" else "bias")
            ours[key] = spec.index("model")
    assert ours == jax_cut and len(ours) == 6


def fp_batch(seed=0):
    rng = np.random.default_rng(seed)
    in_lens = np.array([16, 14, 12, 16, 10, 8, 15, 11], np.int32)
    mel_lens = np.array([64, 60, 50, 64, 40, 36, 62, 44], np.int32)
    b = dict(tokens=np.zeros((B, T_TEXT), np.int32), in_lens=in_lens,
             mel=np.zeros((B, T_MEL, 80), np.float32), mel_lens=mel_lens,
             pitch=np.zeros((B, 1, T_MEL), np.float32), energy=np.zeros((B, T_MEL), np.float32))
    for i in range(B):
        b["tokens"][i, :in_lens[i]] = rng.integers(1, 148, in_lens[i])
        b["mel"][i, :mel_lens[i]] = rng.standard_normal((mel_lens[i], 80)) - 4.0
    return b


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    torch.set_num_threads(1)
    cfg = FastPitchConfig(**fp_kw(64, dropout=0.1))
    torch.manual_seed(0)
    sd = FastPitch(cfg).state_dict()
    fp_case = dict(cfg=dataclasses.asdict(cfg), sd=sd, stage=4, warmup=10, seed=3,
                   batches=[fp_batch(0), fp_batch(1)])
    rng = np.random.default_rng(7)
    lens = np.array([10, 7, 9, 4])
    rpt_case = {"x": rng.standard_normal((4, 32, 10)).astype(np.float32),
                "mask": (np.arange(10)[None, None, :] < lens[:, None, None]).astype(np.float32),
                "w": rng.standard_normal((4, 32, 10)).astype(np.float32)}
    ranks = run_ranks("tp", 4, tmp_path_factory.mktemp("tp"),
                      {"fastpitch": fp_case, "rpt": rpt_case})
    return {"fp": fp_case, "ranks": ranks, "fp_one": run_fastpitch(fp_case),
            "rpt_one": run_rpt(rpt_case)}


def test_tp_step_matches_replicated(tp_runs):
    one = tp_runs["fp_one"]
    for r in tp_runs["ranks"]:
        res = r["fastpitch"]
        assert res["summary"], "no FFN weight was cut"
        for m_r, m_one in zip(res["metas"], one["metas"]):
            loss, ref = float(m_r["loss"]), float(m_one["loss"])
            assert np.isfinite(loss) and abs(loss - ref) < 1e-3 * max(1.0, abs(ref))
        # the blocks reassembled are the replicated step's parameters
        for k, v in res["params"].items():
            ref = one["params"][k]
            assert float((v - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), k
        # each rank held half of every cut FFN weight
        shapes = res["local_shapes"]
        assert shapes["encoder.layers.0.pos_ff.CoreNet.0.weight"][0] == 32
        assert shapes["encoder.layers.0.pos_ff.CoreNet.2.weight"][1] == 32
        assert shapes["encoder.layers.0.pos_ff.CoreNet.2.bias"] == (64,)
    before = tp_runs["fp"]["sd"]
    assert not torch.equal(one["params"]["decoder.layers.0.pos_ff.CoreNet.0.weight"],
                           before["decoder.layers.0.pos_ff.CoreNet.0.weight"])


def test_xvapitch_ffn_tp_with_dropout_matches_replicated(tp_runs):
    one = tp_runs["rpt_one"]
    for r in tp_runs["ranks"]:
        d, _ = r["coords"]
        rows = slice(2 * d, 2 * d + 2)
        for k in ("y", "x_grad"):
            ref = one[k][rows]
            assert float((r["rpt"][k] - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), k
