"""Port parity of the v3 training step against the JAX package, at the tiny
config of tests/test_fused_gd.py (B = 2, 24 tokens, 64 frames), on seeded
weights carried across with the weight norm as flax holds it.

Dropout is off on both sides (a flax interceptor runs ``train_step`` with
``deterministic=True``; the port's modules are in eval mode), and the port is
fed the JAX step's draws: the posterior noise (z - m_q)·exp(-logs_q), the
SDP's noise recorded at its first posterior flow, and the segment starts
found in ``waveform_seg``. Tolerances: ``train_step``'s outputs and every
loss within 1e-4 relative (their max abs); MAS's durations equal; one whole
step (``optax.sgd`` on both sides, the JAX step fused and unfused) within
1e-4 relative on the losses and, for every parameter, its update within
1e-3 of that update's max abs, weight-norm g and v included, plus 1e-6 of
the largest update in the model (the float noise of a gradient that is zero
in exact arithmetic, as an attention key's bias has: the softmax is blind to
it) and 2 ulp of the parameter's largest value (the finest difference that
new - old resolves in fp32).
"""
import jax
import numpy as np
import optax
import pytest
import torch
from torch_v3_common import (HOP, LR, Sgd, assert_updates_match, batch_np, draws_of,
                             jax_batch, jax_forward, port_models, rel_err, run_both_steps,
                             seeded_params, torch_batch)

from xva_trainer_tpu_torch.models.xvapitch import losses
from xva_trainer_tpu_torch.train.xvapitch_trainer import materialize_spec

# channels-last in JAX, channels-first in the port
OUT_KEYS = ("model_outputs", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q")
# the same layout on both sides
SAME_KEYS = ("loss_duration", "pitch_tgt", "pitch_pred")
LOSS_KEYS = ("loss", "loss_mel", "loss_gen", "loss_feat", "loss_kl", "loss_duration",
             "loss_pitch", "per_sample_mel", "per_sample_kl", "per_sample_pitch", "loss_disc")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cf(a):
    """JAX channels-last (B, T, C) → channels-first (B, C, T)."""
    a = np.asarray(a)
    return a.transpose(0, 2, 1) if a.ndim == 3 else a


@pytest.fixture(scope="module")
def case():
    g_params, d_params = seeded_params(0)
    b = batch_np(0)
    out, meta, sdp_noise = jax_forward(g_params, d_params, b)
    return g_params, d_params, b, out, meta, draws_of(out, b, sdp_noise)


def test_materialize_spec_matches_jax(case):
    from xva_trainer_tpu.train.xvapitch_trainer import _materialize_spec

    *_, b, _, _, _ = case
    lin, wav = _materialize_spec(jax_batch(b), hop=HOP)
    o_lin, o_wav = materialize_spec(torch_batch(b), HOP)
    assert o_lin.shape == (2, 513, b["wav"].shape[1] // HOP)
    assert rel_err(o_lin, _cf(lin)) < 1e-4
    assert np.array_equal(o_wav.numpy(), _cf(wav))


def test_train_step_outputs_match_jax(case):
    g_params, d_params, b, out, _, draws = case
    model, _ = port_models(g_params, d_params)
    tb = torch_batch(b)
    linear, wav = materialize_spec(tb, HOP)
    with torch.no_grad():
        ours = model.train_step(tb["tokens"], tb["tlens"], linear, tb["slens"], tb["pitch"],
                                tb["energy"], wav, tb["dvec"], tb["lang"], **draws)
    # MAS on both sides found the same alignment
    assert np.array_equal(ours["attn_durations"].numpy(), out["attn_durations"])
    assert np.array_equal(ours["waveform_seg"].numpy(), _cf(out["waveform_seg"]))
    for k in OUT_KEYS:
        assert rel_err(ours[k], _cf(out[k])) < 1e-4, k
    for k in SAME_KEYS:
        assert rel_err(ours[k], out[k]) < 1e-4, k


def test_generator_loss_components_match_jax(case):
    g_params, d_params, b, _, meta, draws = case
    model, disc = port_models(g_params, d_params)
    tb = torch_batch(b)
    linear, wav = materialize_spec(tb, HOP)
    with torch.no_grad():
        out = model.train_step(tb["tokens"], tb["tlens"], linear, tb["slens"], tb["pitch"],
                               tb["energy"], wav, tb["dvec"], tb["lang"], **draws)
        s_fake, f_fake, s_real, f_real = disc(out["model_outputs"], out["waveform_seg"])
        _, ours = losses.generator_loss(out, s_fake, f_fake, f_real, language_ids=tb["lang"],
                                        spec_lengths=tb["slens"])
        ours["loss_disc"], _ = losses.discriminator_loss(s_real, s_fake)
    for k in LOSS_KEYS:
        assert rel_err(ours[k], meta[k]) < 1e-4, k


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_one_step_matches_make_v3_step(case, fused):
    j_meta, p_meta, old, new, j_old, j_new, _ = run_both_steps(case, fused=fused)
    for k in ("loss", "loss_disc", "loss_mel", "loss_kl", "loss_duration"):
        assert rel_err(p_meta[k], j_meta[k]) < 1e-4, k
    for i in range(2):  # the generator, then the discriminator
        assert_updates_match(old[i], new[i], j_old[i], j_new[i])
    # the step moved the weight-normed pairs of every family
    for k in ("posterior_encoder.enc.in_layers.0.weight_g", "waveform_decoder.ups.0.weight_g",
              "waveform_decoder.ups.0.weight_v", "waveform_decoder.resblocks.0.convs1.0.weight_v"):
        assert (new[0][k] != old[0][k]).any(), k
    for k in ("nets.0.convs.1.weight_g", "nets.3.convs.2.weight_v"):
        assert (new[1][k] != old[1][k]).any(), k


def test_freeze_post_dec_matches_jax(case):
    """freeze_post_dec: the posterior encoder and the decoder get no update,
    not even weight decay; every other update matches the JAX step's."""
    def tx():
        return optax.chain(optax.add_decayed_weights(0.01), optax.sgd(LR))

    def opt(params):
        return Sgd(params, weight_decay=0.01)

    j_meta, p_meta, old, new, j_old, j_new, _ = run_both_steps(
        case, jax_tx=tx, port_opt=opt, freeze_post_dec=True)
    assert rel_err(p_meta["loss"], j_meta["loss"]) < 1e-4
    frozen = [k for k in new[0] if k.split(".")[0] in ("posterior_encoder", "waveform_decoder")]
    assert frozen and all(torch.equal(new[0][k], old[0][k]) for k in frozen)
    assert all(np.array_equal(j_new[0][k].numpy(), j_old[0][k].numpy()) for k in frozen)
    assert (new[0]["text_encoder.proj.weight"] != old[0]["text_encoder.proj.weight"]).any()
    for i in range(2):
        assert_updates_match(old[i], new[i], j_old[i], j_new[i])
