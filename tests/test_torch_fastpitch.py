"""Port parity of FastPitch, its losses and the attention priors against the
JAX package, in fp32 on the CPU.

The JAX FastPitch at a small width (2 + 2 layers, 64 wide, filters 128, no
dropout) with seeded parameters, carried into the port by
``interop/convert.py::fastpitch_state_dict``. Every layer, ``regulate_len``,
``average_pitch``, the staged forwards and the four stage losses are held to
JAX within 1e-5 of the reference's max abs (``close``); MAS paths and
durations must be identical. The batch holds an all-zero padded row (as
``BucketBatcher.collate`` pads a bucket's short last batch: tokens 0,
lengths 1), whose keys are all masked, and the CTC is also held on an item
with fewer frames than tokens, where optax's value is finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_v3_common import fastpitch_configs, port_fastpitch, seeded_fastpitch

from xva_trainer_tpu.data.prior import BetaBinomialInterpolator as JaxInterpolator
from xva_trainer_tpu.models.fastpitch import FastPitch as JaxFastPitch
from xva_trainer_tpu.models.fastpitch import average_pitch as jax_average_pitch
from xva_trainer_tpu.models.fastpitch import layers as jl
from xva_trainer_tpu.models.fastpitch import loss as jax_loss
from xva_trainer_tpu.models.fastpitch import regulate_len as jax_regulate_len
from xva_trainer_tpu.ops.attn_prior import beta_binomial_attn_prior as jax_attn_prior
from xva_trainer_tpu_torch.data.prior import BetaBinomialInterpolator
from xva_trainer_tpu_torch.models.fastpitch import average_pitch, regulate_len
from xva_trainer_tpu_torch.models.fastpitch import layers as pl
from xva_trainer_tpu_torch.models.fastpitch import loss as port_loss
from xva_trainer_tpu_torch.ops.attn_prior import beta_binomial_attn_prior

JCFG, CFG = fastpitch_configs()
B, T_TEXT, T_MEL = 4, 12, 40
REL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def close(port, ref, rel=REL, what=""):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all() and np.isfinite(ref).all(), what
    err = float(np.abs(port - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rel * scale, f"{what}: max abs err {err} against max |ref| {scale}"


def make_batch(seed=0):
    """Three real items and one all-zero padded row, as collate emits them."""
    rng = np.random.default_rng(seed)
    in_lens = np.array([12, 9, 5, 1], np.int32)
    mel_lens = np.array([40, 31, 17, 1], np.int32)
    tokens = np.zeros((B, T_TEXT), np.int32)
    mel = np.zeros((B, T_MEL, 80), np.float32)
    pitch = np.zeros((B, 1, T_MEL), np.float32)
    energy = np.zeros((B, T_MEL), np.float32)
    for b in range(3):
        tokens[b, :in_lens[b]] = rng.integers(1, 148, in_lens[b])
        mel[b, :mel_lens[b]] = rng.standard_normal((mel_lens[b], 80)) - 4.0
        p = rng.standard_normal(mel_lens[b])
        p[rng.random(mel_lens[b]) < 0.3] = 0.0
        pitch[b, 0, :mel_lens[b]] = p
        energy[b, :mel_lens[b]] = np.abs(rng.standard_normal(mel_lens[b])) * 20
    prior = np.asarray(jax_attn_prior(jnp.asarray(in_lens), jnp.asarray(mel_lens), T_TEXT, T_MEL))
    return dict(tokens=tokens, in_lens=in_lens, mel=mel, mel_lens=mel_lens, pitch=pitch,
                energy=energy, prior=prior)


@pytest.fixture(scope="module")
def models():
    params = seeded_fastpitch(JCFG, seed=1, t_text=T_TEXT, t_mel=T_MEL)
    return JaxFastPitch(JCFG), params, port_fastpitch(params, CFG)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def T(b):
    return {k: torch.from_numpy(np.asarray(v)).long() if np.asarray(v).dtype == np.int32
            else torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_apply(models, method, *args, **kw):
    model, params, _ = models
    return model.apply(params, *args, method=method, **kw)


# ---------------- layers ----------------


def test_sinusoid_positions():
    close(pl.sinusoid_positions(37, 64), jl.sinusoid_positions(37, 64), what="positions")


def _sub(params, *path):
    node = params["params"]
    for p in path:
        node = node[p]
    return {"params": node}


def test_layers_match_jax(models, batch):
    """Each layer of the encoder, decoder, predictors and aligner alone, on
    inputs with masked rows (one row with every key masked)."""
    _, params, port = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T_TEXT, 64)).astype(np.float32)
    mask = (np.arange(T_TEXT)[None, :] < np.array([12, 9, 5, 0])[:, None])[..., None]
    mask = mask.astype(np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        # one encoder layer's attention (a row with every key masked) and FF
        ref = jl.MultiHeadAttn(1, 32, 0.0, 0.0).apply(
            _sub(params, "encoder", "attn_layers_0"), x, mask)
        close(port.encoder.layers[0].dec_attn(xt, mt), ref, what="MultiHeadAttn")
        ref = jl.PositionwiseConvFF(128, 3, 0.0).apply(_sub(params, "decoder", "ff_layers_1"), x)
        close(port.decoder.layers[1].pos_ff(xt), ref, what="PositionwiseConvFF")
        # a predictor, its first ConvReLUNorm, and the pitch embedding's Conv1d
        ref = jl.TemporalPredictor(128, 3, 0.0, 2).apply(
            _sub(params, "pitch_predictor"), x, mask)
        close(port.pitch_predictor(xt, mt), ref, what="TemporalPredictor")
        ref = jl.ConvReLUNorm(128, 3, 0.0).apply(
            _sub(params, "energy_predictor", "ConvReLUNorm_0"), x, deterministic=True)
        close(port.energy_predictor.layers[0](xt), ref, what="ConvReLUNorm")
        p1 = rng.standard_normal((B, T_TEXT, 1)).astype(np.float32)
        ref = jl.Conv1d(64, 3).apply(_sub(params, "pitch_emb"), p1)
        close(port.pitch_emb(torch.from_numpy(p1)), ref, what="Conv1d")
        # both transformers: tokens with an all-padding row; frames with a
        # length-0 row
        tb = T(batch)
        ref, ref_mask = jl.FFTransformer(2, 1, 64, 32, 128, 3, 0.0, 0.0).apply(
            _sub(params, "encoder"), jnp.asarray(batch["tokens"]))
        out, out_mask = port.encoder(tb["tokens"])
        close(out, ref, what="encoder")
        close(out_mask, ref_mask, what="encoder mask")
        lens = np.array([T_TEXT, 7, 3, 0], np.int32)
        ref, _ = jl.FFTransformer(2, 1, 64, 32, 128, 3, 0.0, 0.0, embed_input=False).apply(
            _sub(params, "decoder"), x, jnp.asarray(lens))
        close(port.decoder(xt, seq_lens=torch.from_numpy(lens).long())[0], ref, what="decoder")
        # the aligner, with and without the prior
        emb = np.asarray(params["params"]["encoder"]["word_emb"]["embedding"])[batch["tokens"]]
        key_pad = (batch["tokens"] != 0).astype(np.float32)
        for prior in (batch["prior"], None):
            ref = jl.ConvAttention(80, 64, 80).apply(
                _sub(params, "attention"), batch["mel"], emb, key_pad, prior)
            out = port.attention(tb["mel"], torch.from_numpy(emb), torch.from_numpy(key_pad),
                                 None if prior is None else tb["prior"])
            close(out[0], ref[0], what="ConvAttention soft")
            close(out[1], ref[1], what="ConvAttention logprob")


def test_masked_rows_are_uniform_not_nan():
    """The trap: a -inf fill makes a row with every key masked NaN."""
    attn = pl.MultiHeadAttn(16, 1, 16, 0.0, 0.0)
    x = torch.randn(2, 5, 16)
    mask = torch.zeros(2, 5, 1)
    mask[0, :3] = 1
    assert torch.isfinite(attn(x, mask)).all()


def test_regulate_len_and_average_pitch():
    rng = np.random.default_rng(4)
    durs = rng.integers(0, 5, (B, T_TEXT)).astype(np.float32)
    durs[1, 3] = 2.5  # rounds half up
    enc = rng.standard_normal((B, T_TEXT, 8)).astype(np.float32)
    for pace, mel_max_len in ((1.0, 40), (1.3, 24)):  # 24: the lengths clamp
        ref, ref_lens = jax_regulate_len(jnp.asarray(durs), jnp.asarray(enc), pace, mel_max_len)
        out, lens = regulate_len(torch.from_numpy(durs), torch.from_numpy(enc), pace,
                                 mel_max_len)
        close(out, ref, what="regulate_len")
        assert np.array_equal(lens.numpy(), np.asarray(ref_lens))
    pitch = rng.standard_normal((B, 1, T_MEL)).astype(np.float32)
    pitch[rng.random(pitch.shape) < 0.3] = 0.0
    durs[0] = 5  # runs past the frames: the bounds clip
    close(average_pitch(torch.from_numpy(pitch), torch.from_numpy(durs)),
          jax_average_pitch(jnp.asarray(pitch), jnp.asarray(durs)), what="average_pitch")


# ---------------- the staged forwards ----------------


def test_stage1_stage2_match_jax(models, batch):
    _, _, port = models
    jb, tb = J(batch), T(batch)
    args = ("tokens", "in_lens", "mel", "mel_lens", "prior")
    ref = jax_apply(models, JaxFastPitch.stage1, *(jb[k] for k in args))
    with torch.no_grad():
        out = port.stage1(*(tb[k] for k in args))
    for k in ("attn_soft", "attn_logprob"):
        close(out[k], ref[k], what=k)
    assert np.array_equal(out["attn_hard"].numpy(), np.asarray(ref["attn_hard"]))
    assert np.array_equal(out["durations"].numpy(), np.asarray(ref["durations"]))
    assert out["durations"].sum(1).tolist() == [40, 31, 17, 1]

    ref = jax_apply(models, JaxFastPitch.stage2, *(jb[k] for k in args))
    with torch.no_grad():
        out = port.stage2(*(tb[k] for k in args))
    assert np.array_equal(out["durations"].numpy(), np.asarray(ref["durations"]))
    for k in ("log_dur_pred", "dur_pred"):
        close(out[k], ref[k], what=k)

    durs = np.asarray(ref["durations"])
    ref = jax_apply(models, JaxFastPitch.stage2_from_durs, jb["tokens"], jb["in_lens"],
                    jnp.asarray(durs))
    with torch.no_grad():
        out = port.stage2_from_durs(tb["tokens"], tb["in_lens"], torch.from_numpy(durs))
    close(out["log_dur_pred"], ref["log_dur_pred"], what="log_dur_pred from durs")


@pytest.mark.parametrize("run_aligner", [True, False])
def test_full_matches_jax(models, batch, run_aligner):
    _, _, port = models
    jb, tb = J(batch), T(batch)
    durs = np.asarray(jax_apply(models, JaxFastPitch.stage1, jb["tokens"], jb["in_lens"],
                                jb["mel"], jb["mel_lens"], jb["prior"])["durations"])
    args = ("tokens", "in_lens", "mel", "mel_lens", "pitch", "energy", "prior")
    kw = {} if run_aligner else dict(run_aligner=False)
    ref = jax_apply(models, JaxFastPitch.full, *(jb[k] for k in args),
                    durs_gt=None if run_aligner else jnp.asarray(durs), **kw)
    with torch.no_grad():
        out = port.full(*(tb[k] for k in args),
                        durs_gt=None if run_aligner else torch.from_numpy(durs), **kw)
    assert np.array_equal(out["durations"].numpy(), np.asarray(ref["durations"]))
    assert np.array_equal(out["dec_lens"].numpy(), np.asarray(ref["dec_lens"]))
    for k in ("mel_out", "dec_mask", "dur_pred", "log_dur_pred", "pitch_pred", "pitch_tgt",
              "energy_pred", "energy_tgt"):
        close(out[k], ref[k], what=k)


def test_infer_matches_jax(models, batch):
    _, _, port = models
    ref = jax_apply(models, JaxFastPitch.infer, jnp.asarray(batch["tokens"]), mel_max_len=64)
    with torch.no_grad():
        out = port.infer(T(batch)["tokens"], mel_max_len=64)
    assert np.array_equal(out["dec_lens"].numpy(), np.asarray(ref["dec_lens"]))
    for k in ("mel_out", "dur_pred", "pitch_pred"):
        close(out[k], ref[k], what=k)


# ---------------- the losses ----------------


def _stage_outputs(models, batch):
    jb, tb = J(batch), T(batch)
    args = ("tokens", "in_lens", "mel", "mel_lens", "prior")
    j1 = jax_apply(models, JaxFastPitch.stage1, *(jb[k] for k in args))
    j2 = jax_apply(models, JaxFastPitch.stage2, *(jb[k] for k in args))
    args = ("tokens", "in_lens", "mel", "mel_lens", "pitch", "energy", "prior")
    j3 = jax_apply(models, JaxFastPitch.full, *(jb[k] for k in args))
    t = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in o.items() if v is not None}
         for k, o in (("1", j1), ("2", j2), ("3", j3))}
    return (j1, j2, j3), t, jb, tb


def test_stage_losses_match_jax(models, batch):
    """The four stage losses on JAX's own outputs, with the padded row."""
    (j1, j2, j3), t, jb, tb = _stage_outputs(models, batch)
    kl = 0.37
    ref = jax_loss.stage1_loss(j1, jb["in_lens"], jb["mel_lens"], jnp.asarray(kl))
    out = port_loss.stage1_loss(t["1"], tb["in_lens"], tb["mel_lens"], kl)
    for k in ref[1]:
        close(out[1][k], ref[1][k], what=f"stage 1 {k}")
    ref = jax_loss.stage2_loss(j2, jb["in_lens"])
    out = port_loss.stage2_loss(t["2"], tb["in_lens"])
    for k in ref[1]:
        close(out[1][k], ref[1][k], what=f"stage 2 {k}")
    ref = jax_loss.stage3_loss(j3, jb["mel"], jb["in_lens"])
    out = port_loss.stage3_loss(t["3"], tb["mel"], tb["in_lens"])
    for k in ref[1]:
        close(out[1][k], ref[1][k], what=f"stage 3 {k}")
    ref = jax_loss.stage4_loss(j3, jb["mel"])
    out = port_loss.stage4_loss(t["3"], tb["mel"])
    close(out[0], ref[0], what="stage 4")


# value and gradient of JAX's CTC, compiled once for the cases' one shape
_JAX_CTC = jax.jit(jax.value_and_grad(jax_loss.attention_ctc_loss))
CTC_CASES = {  # name: (in_lens, mel_lens, all_aligned)
    # an item with fewer frames than tokens: optax's large finite value,
    # where a bare F.ctc_loss gives inf
    "unaligned": ([8, 6, 3], [10, 4, 7], None),
    # every item aligned, through optax's recursion in torch
    "recursion": ([8, 6, 3], [10, 9, 7], False),
    # every item aligned: F.ctc_loss and its gradient
    "aligned": ([8, 4, 1], [10, 8, 1], None),
}


@pytest.mark.parametrize("case", list(CTC_CASES))
def test_ctc_matches_optax(case):
    in_lens, mel_lens, all_aligned = (np.asarray(v, np.int32) if v is not None else v
                                      for v in CTC_CASES[case])
    rng = np.random.default_rng(6)
    logprob = (rng.standard_normal((3, 10, 8)) * 2).astype(np.float32)
    ref, ref_grad = _JAX_CTC(jnp.asarray(logprob), jnp.asarray(in_lens), jnp.asarray(mel_lens))
    x = torch.from_numpy(logprob).requires_grad_(True)
    out = port_loss.attention_ctc_loss(x, torch.from_numpy(in_lens).long(),
                                       torch.from_numpy(mel_lens).long(), all_aligned)
    out.backward()
    aligned = mel_lens >= in_lens
    assert np.isfinite(float(ref)) and (aligned.all() or float(ref) > 1e4)
    close(out, ref, what="ctc")
    # the aligned items' gradients within 1e-4; an unaligned item's sum
    # log-probabilities near -1e5, where fp32 resolves 2^-7 in log space,
    # so each side's exp() of their differences carries up to ~1% error
    close(x.grad[aligned], np.asarray(ref_grad)[aligned], rel=1e-4, what="ctc gradient")
    if not aligned.all():
        close(x.grad[~aligned], np.asarray(ref_grad)[~aligned], rel=2e-2,
              what="ctc gradient, no alignment")


# ---------------- the priors ----------------


def test_device_prior_matches_jax():
    in_lens, mel_lens = np.array([1, 37, 64, 5]), np.array([1, 120, 256, 250])
    ref = jax_attn_prior(jnp.asarray(in_lens), jnp.asarray(mel_lens), 64, 256)
    out = beta_binomial_attn_prior(torch.from_numpy(in_lens), torch.from_numpy(mel_lens), 64, 256)
    close(out, ref, what="device prior")


@pytest.mark.parametrize("mel_len,text_len", [(1, 1), (37, 11), (250, 64), (896, 200)])
def test_host_prior_matches_jax(mel_len, text_len):
    close(BetaBinomialInterpolator()(mel_len, text_len), JaxInterpolator()(mel_len, text_len),
          rel=0.0, what="host prior")
