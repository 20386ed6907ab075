"""Port parity of the training-side modules against the JAX package: the VITS
discriminator (scores and feature maps within 1e-4 max abs; the LSGAN and
feature-matching losses within 1e-5 relative), the SDP's training NLL
(within 1e-4 relative, on the noise the JAX module drew, recorded at its
first posterior flow), the pitch target, and the weight norm's axis: every
weight-normed conv of both packages normalises over its output axis."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_v3_common import JCFG, TCFG, _sow_draws, port_models, rel_err, seeded_params

import flax.linen as nn
from xva_trainer_tpu.models.fastpitch.model import average_pitch as jax_average_pitch
from xva_trainer_tpu.models.hifigan.models import discriminator_loss as jax_d_loss
from xva_trainer_tpu.models.hifigan.models import feature_matching_loss as jax_fm_loss
from xva_trainer_tpu.models.hifigan.models import generator_adv_loss as jax_g_loss
from xva_trainer_tpu.models.xvapitch import VitsDiscriminator as JaxVitsDiscriminator
from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu_torch.interop.convert import vits_disc_state_dict
from xva_trainer_tpu_torch.models.hifigan.models import (discriminator_loss,
                                                         feature_matching_loss,
                                                         generator_adv_loss)
from xva_trainer_tpu_torch.models.xvapitch import VitsDiscriminator, XVAPitch
from xva_trainer_tpu_torch.models.xvapitch.model import average_pitch
from xva_trainer_tpu_torch.models.xvapitch.modules import gradient_reversal


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return seeded_params(0)


def _fmap_to_torch(f):
    """JAX channels-last feature map → the port's layout: (B, T, C) →
    (B, C, T); (B, T/p, p, C) → (B, C, T/p, p)."""
    f = np.asarray(f)
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 3, 1, 2)


@pytest.fixture(scope="module", params=[2048, 1999], ids=["segment", "odd_length"])
def scored(request, params):
    """Both discriminators on the same fake and real waveforms (an odd length
    makes every period reflect-pad)."""
    _, d_params = params
    n = request.param
    rng = np.random.default_rng(n)
    fake = np.tanh(rng.standard_normal((2, n, 1))).astype(np.float32)
    real = (0.5 * np.sin(np.arange(n) / 7.0)[None, :, None]
            + 0.05 * rng.standard_normal((2, n, 1))).astype(np.float32)
    ref = jax.jit(JaxVitsDiscriminator().apply)(d_params, fake, real)
    disc = VitsDiscriminator().eval()
    disc.load_state_dict(vits_disc_state_dict(d_params), strict=True)

    def cf(a):
        return torch.from_numpy(a.transpose(0, 2, 1).copy())

    ours = disc(cf(fake), cf(real))
    return jax.tree_util.tree_map(np.asarray, ref), ours


def test_discriminator_scores_and_feature_maps(scored):
    ref, ours = scored
    for side in (0, 2):  # fake, real
        assert len(ours[side]) == len(ref[side]) == 6
        for o, r in zip(ours[side], ref[side]):
            assert o.shape == r.shape
            assert np.abs(o.detach().numpy() - r).max() < 1e-4
    for side in (1, 3):
        for fo, fr in zip(ours[side], ref[side]):
            assert len(fo) == len(fr)
            for o, r in zip(fo, fr):
                r = _fmap_to_torch(r)
                assert o.shape == r.shape
                assert np.abs(o.detach().numpy() - r).max() < 1e-4


def test_gan_losses(scored):
    ref, ours = scored
    s_f, f_f, s_r, f_r = ours
    j_s_f, j_f_f, j_s_r, j_f_r = ref
    assert rel_err(generator_adv_loss(s_f).item(), jax_g_loss(j_s_f)) < 1e-5
    assert rel_err(discriminator_loss(s_r, s_f).item(), jax_d_loss(j_s_r, j_s_f)) < 1e-5
    assert rel_err(feature_matching_loss(f_r, f_f).item(), jax_fm_loss(j_f_r, j_f_f)) < 1e-5
    # no gradient reaches the real side's feature maps
    fm = feature_matching_loss(f_r, f_f)
    grads = torch.autograd.grad(fm, [f_f[0][0], f_r[0][0]], allow_unused=True)
    assert grads[0] is not None and grads[0].abs().sum() > 0 and grads[1] is None


def test_sdp_training_nll(params):
    """The SDP's forward direction: flows over the posterior noise, the
    log-sigmoid logdet, log(clamp(z0, 1e-5)), the flow NLL; the text
    encoding and the speaker embedding detached, the language embedding
    not."""
    g_params, d_params = params
    rng = np.random.default_rng(4)
    B, T, C = 2, 12, TCFG.latent_size + TCFG.lang_emb_dim
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x_mask = (np.arange(T)[None, :] < np.array([T, T - 3])[:, None]).astype(np.float32)[..., None]
    dr = (rng.integers(1, 6, (B, T, 1)) * x_mask).astype(np.float32)
    g = (rng.standard_normal((B, 512)) * 0.3).astype(np.float32)
    lang = np.array([5, 2], np.int32)

    def nll(mdl, x, x_mask, dr, g, lang):
        return mdl.duration_predictor(x, x_mask, dr=dr, g=g, lang_emb=mdl.emb_l(lang),
                                      deterministic=True)

    with nn.intercept_methods(_sow_draws):
        ref, inter = JaxXVAPitch(JCFG).apply(g_params, x, x_mask, dr, g, lang, method=nll,
                                             rngs={"noise": jax.random.PRNGKey(11)},
                                             mutable=["intermediates"])
    noise = jax.tree_util.tree_leaves(inter)[0]

    model, _ = port_models(g_params, d_params)

    def cf(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))

    tx = cf(x).requires_grad_(True)
    tg = torch.from_numpy(g).requires_grad_(True)
    lang_emb = model.emb_l(torch.from_numpy(lang).long())
    ours = model.duration_predictor(tx, cf(x_mask), cf(dr), g=tg.detach(), lang_emb=lang_emb,
                                    noise=cf(noise))
    assert ours.shape == (B,) and rel_err(ours.detach(), ref) < 1e-4
    ours.sum().backward()
    assert tx.grad is None  # the text encoding is detached inside
    assert model.emb_l.weight.grad is not None and model.emb_l.weight.grad.abs().sum() > 0


def test_average_pitch_matches_jax():
    rng = np.random.default_rng(5)
    pitch = rng.standard_normal((3, 1, 50)).astype(np.float32)
    pitch[rng.random(pitch.shape) < 0.4] = 0.0
    durs = rng.integers(0, 5, (3, 14)).astype(np.float32)
    durs[1, 10:] = 0
    durs[2, 0] = 40  # runs past the end of the frames
    ref = np.asarray(jax_average_pitch(jnp.asarray(pitch), jnp.asarray(durs)))
    ours = average_pitch(torch.from_numpy(pitch), torch.from_numpy(durs))
    assert ours.shape == (3, 1, 14) and np.allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_gradient_reversal():
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    y = gradient_reversal(x, 0.25)
    assert torch.equal(y, x)
    (y * torch.linspace(-2, 2, 7)).sum().backward()
    assert torch.allclose(x.grad, -torch.clamp(torch.linspace(-2, 2, 7), -0.25, 0.25))


def _weight_normed(module):
    """{name: output axis} of every weight-normed conv, after checking that
    its weight_g holds one value per output channel along that axis."""
    out = {}
    for name, m in module.named_modules():
        if hasattr(m, "weight_g"):
            axis = 1 if isinstance(m, torch.nn.ConvTranspose1d) else 0
            expect = [1] * m.weight_v.dim()
            expect[axis] = m.weight_v.shape[axis]
            assert list(m.weight_g.shape) == expect, name
            out[name] = axis
    return out


def test_weight_norm_over_output_axis(params):
    """Every weight-normed conv normalises over its output axis: the WN
    layers, the resblocks, the decoder's upsampling ConvTranspose1d (dim 1,
    as flax's WeightNorm around ConvTranspose), and the discriminators'
    Conv1d/Conv2d; flax holds one scale per output feature for each, and the
    carried (weight_g, weight_v) give flax's effective weight."""
    g_params, d_params = params
    model, disc = port_models(g_params, d_params)
    for mod in (model, disc):
        assert _weight_normed(mod)
    assert set(_weight_normed(XVAPitch(TCFG).waveform_decoder.ups).values()) == {1}
    assert len(_weight_normed(disc)) == 7 + 5 * 6  # each with its conv_post
    # flax: w = scale * kernel / ||kernel|| over every axis but the last
    p = g_params["params"]["waveform_decoder"]
    kernel = np.asarray(p["ConvTranspose_0"]["kernel"], np.float64)
    scale = np.asarray(p["WeightNorm_0"]["ConvTranspose_0/kernel/scale"], np.float64)
    w = kernel / np.sqrt((kernel ** 2).sum(axis=(0, 1), keepdims=True)) * scale
    up = model.waveform_decoder.ups[0]
    eff = torch._weight_norm(up.weight_v, up.weight_g, 1).detach().numpy()
    assert np.allclose(eff, w[::-1].transpose(1, 2, 0), rtol=1e-5, atol=1e-7)
    dp = d_params["params"]["DiscriminatorP_0"]
    kernel = np.asarray(dp["Conv_0"]["kernel"], np.float64)  # (k, 1, in, out)
    scale = np.asarray(dp["WeightNorm_0"]["Conv_0/kernel/scale"], np.float64)
    w = kernel / np.sqrt((kernel ** 2).sum(axis=(0, 1, 2), keepdims=True)) * scale
    conv = disc.nets[1].convs[0]
    eff = torch._weight_norm(conv.weight_v, conv.weight_g, 0).detach().numpy()
    assert np.allclose(eff, w.transpose(3, 2, 0, 1), rtol=1e-5, atol=1e-7)
