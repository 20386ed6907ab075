"""The guards of the port's v3 step against the JAX package's, at the tiny
config of tests/test_fused_gd.py, and the step's own draws:

- ``hifi_only``: only the posterior encoder and the decoder move, and their
  updates match the JAX step's (``optax.sgd`` with weight decay on both
  sides: no other module decays either);
- the NaN guard: a batch whose generator loss is not finite zeroes the
  generator's gradients and still runs its AdamW, whose moments stay zero,
  whose count advances and whose weight decay applies, as the JAX step's
  state shows;
- dropout and every draw come from the passed generator, never the global
  RNG; AMP (bf16 autocast, here on the CPU) keeps fp32 masters and a loss
  within 5% of the fp32 step's, the bar tests/test_amp.py sets for JAX.

Tolerances as in tests/test_torch_train_step.py.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch
from torch_v3_common import (LR, TCFG, UNUSED, Sgd, assert_updates_match, batch_np, draws_of,
                             jax_forward, port_models, rel_err, run_both_steps, seeded_params,
                             torch_batch)

from xva_trainer_tpu.train.optim import make_gan_optimizer as jax_make_gan_optimizer
from xva_trainer_tpu_torch.models.xvapitch import VitsDiscriminator, XVAPitch
from xva_trainer_tpu_torch.train.optim import GanOptimizer
from xva_trainer_tpu_torch.train.xvapitch_trainer import (POST_DEC, XvaTrainConfig,
                                                          make_optimizers, make_v3_loss_eval,
                                                          make_v3_step, module_mask,
                                                          update_mask)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return seeded_params(0)


def _sgd_wd():
    return optax.chain(optax.add_decayed_weights(0.01), optax.sgd(LR))


def test_hifi_only_matches_jax(params):
    g_params, d_params = params
    b = batch_np(1)
    out, meta, _ = jax_forward(g_params, d_params, b, hifi_only=True)
    case = (g_params, d_params, b, out, meta, draws_of(out, b))
    j_meta, p_meta, old, new, j_old, j_new, _ = run_both_steps(
        case, jax_tx=_sgd_wd, port_opt=lambda p: Sgd(p, weight_decay=0.01), hifi_only=True)
    for k in ("loss", "loss_mel", "loss_gen", "loss_feat", "loss_disc"):
        assert rel_err(p_meta[k], j_meta[k]) < 1e-4, k
    moved = {k for k in new[0] if not torch.equal(new[0][k], old[0][k])}
    assert moved and all(k.split(".")[0] in POST_DEC for k in moved)
    assert any(k.startswith("posterior_encoder.") for k in moved)
    assert any(k.startswith("waveform_decoder.") for k in moved)
    for i in range(2):
        assert_updates_match(old[i], new[i], j_old[i], j_new[i])


def test_nan_guard_matches_jax(params):
    """Unvoiced-or-NaN pitch makes the prior, and so the generator loss, NaN;
    the discriminator's loss stays finite (its fakes come from the
    posterior), and its SGD step is held to JAX's as usual."""
    g_params, d_params = params
    b = batch_np(0)
    b["pitch"][0, 0, 5] = np.nan
    out, meta, sdp_noise = jax_forward(g_params, d_params, b)
    assert not np.isfinite(meta["loss"]) and np.isfinite(meta["loss_disc"])
    case = (g_params, d_params, b, out, meta, draws_of(out, b, sdp_noise))

    # AdamW on the generator, SGD on the discriminator (each side makes the
    # generator's optimiser first)
    txs = iter([jax_make_gan_optimizer(1.75e-4), optax.sgd(LR)])
    makers = iter([lambda p: GanOptimizer(p, 1.75e-4), Sgd])
    made = []

    def port_opt(p):
        made.append(next(makers)(p))
        return made[-1]

    j_meta, p_meta, old, new, j_old, j_new, j_state = run_both_steps(
        case, jax_tx=lambda: next(txs), port_opt=port_opt)
    assert not np.isfinite(j_meta["loss"]) and not torch.isfinite(p_meta["loss"])
    g_opt = made[0]
    assert g_opt.count == 1 and int(j_state.g_opt[0].count) == 1
    assert not any(m.any() for m in g_opt.mu) and not any(v.any() for v in g_opt.nu)
    # every generator parameter only decayed: p (1 - lr wd)
    decay = 1.0 - 1.75e-4 * 0.01
    for k, v in new[0].items():
        assert torch.allclose(v, old[0][k] * decay, rtol=1e-6, atol=0), k
        if k not in UNUSED:
            assert np.allclose(v.numpy(), j_new[0][k].numpy(), rtol=1e-6, atol=1e-9), k
    assert_updates_match(old[1], new[1], j_old[1], j_new[1])


def _tiny_step(params, use_amp=False, train=True):
    g_params, d_params = params
    model, disc = port_models(g_params, d_params)
    model.train(train)
    disc.train(train)
    g_opt, d_opt = make_optimizers(model, disc, XvaTrainConfig(batch_size=2, target_bs=2), 1)
    step = make_v3_step(model, disc, g_opt, d_opt, freeze_post_dec=False, use_amp=use_amp)
    return model, step


def test_draws_come_from_the_generator(params):
    """Two steps from the same state and the same seeded generator give the
    same losses; another seed gives other ones; without a generator a
    training-mode step refuses rather than read the global RNG."""
    b = torch_batch(batch_np(0))
    losses = []
    for seed in (5, 5, 6):
        _, step = _tiny_step(params)
        losses.append(float(step(b, torch.Generator().manual_seed(seed))["loss"]))
    assert losses[0] == losses[1] != losses[2]
    _, step = _tiny_step(params)
    with pytest.raises(ValueError, match="Generator"):
        step(b)


def test_dropout_only_in_training_mode(params):
    """In eval mode the draws are the only randomness: passing them makes
    the loss independent of the generator; in training mode the dropout
    masks change it."""
    b = torch_batch(batch_np(0))
    draws = {"noise": torch.randn((2, TCFG.latent_size, 64), generator=torch.Generator()),
             "dp_noise": torch.randn((2, 2, 24), generator=torch.Generator()),
             "seg_u": torch.tensor([0.3, 0.7])}
    out = {}
    for train in (False, True):
        for seed in (1, 2):
            _, step = _tiny_step(params, train=train)
            out[train, seed] = float(step(b, torch.Generator().manual_seed(seed), **draws)["loss"])
    assert out[False, 1] == out[False, 2]
    assert out[True, 1] != out[True, 2]


def test_amp_step_close_to_fp32(params):
    b = torch_batch(batch_np(0))
    loss = {}
    for use_amp in (False, True):
        model, step = _tiny_step(params, use_amp=use_amp, train=False)
        meta = step(b, torch.Generator().manual_seed(0))
        loss[use_amp] = float(meta["loss"])
        assert meta["loss"].dtype == torch.float32 and np.isfinite(loss[use_amp])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert abs(loss[True] - loss[False]) / abs(loss[False]) < 0.05


def test_masks_and_config():
    model = XVAPitch(TCFG)
    post_dec = module_mask(model)
    names = [n for n, _ in model.named_parameters()]
    assert post_dec == [n.split(".")[0] in POST_DEC for n in names] and any(post_dec)
    assert update_mask(model, freeze_post_dec=True, hifi_only=False) == [not m for m in post_dec]
    # hifi_only overrides the freeze: it would otherwise leave nothing to train
    assert update_mask(model, freeze_post_dec=True, hifi_only=True) == post_dec
    assert all(update_mask(model, freeze_post_dec=False, hifi_only=False))
    assert XvaTrainConfig().gam == 7 and XvaTrainConfig(batch_size=400).gam == 1
    g_opt, d_opt = make_optimizers(model, VitsDiscriminator(), XvaTrainConfig(optimizer="lion"), 7)
    assert g_opt.kind == "lion" and g_opt.lr == pytest.approx(1.75e-4 / 5)
    assert d_opt.weight_decay == pytest.approx(0.05) and g_opt.grad_accum == 7


def test_loss_eval_per_sample(params):
    """make_v3_loss_eval gives the step's per-sample mel + KL + pitch terms."""
    model, disc = port_models(*params)
    b = torch_batch(batch_np(0))
    draws = {"noise": torch.randn((2, TCFG.latent_size, 64), generator=torch.Generator()),
             "dp_noise": torch.randn((2, 2, 24), generator=torch.Generator()),
             "seg_u": torch.tensor([0.3, 0.7])}
    per = make_v3_loss_eval(model, use_amp=False)(b, **draws)
    g_opt, d_opt = (Sgd(m.parameters(), lr=0.0) for m in (model, disc))
    meta = make_v3_step(model, disc, g_opt, d_opt, False, use_amp=False)(b, **draws)
    ref = meta["per_sample_mel"] + meta["per_sample_kl"] + meta["per_sample_pitch"]
    assert per.shape == (2,) and torch.allclose(per, ref, rtol=1e-5)


def test_config_fields_match_jax():
    from xva_trainer_tpu.train.xvapitch_trainer import XvaTrainConfig as JaxXvaTrainConfig
    from xva_trainer_tpu.train.xvapitch_trainer import xva_target_deltas as jax_deltas
    from xva_trainer_tpu_torch.train.xvapitch_trainer import xva_target_deltas

    ours, ref = XvaTrainConfig(), JaxXvaTrainConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.gam == ref.gam
    for n in (100, 3000, 9000, 50000):
        assert xva_target_deltas(n) == jax_deltas(n)


def test_pitch_normalisation_matches_the_feature_cache():
    """The cache's (f0 - mean) / std on voiced frames, 0 elsewhere."""
    from xva_trainer_tpu.data import xva_dataset as jax_ds
    from xva_trainer_tpu_torch.data.xva_dataset import (XVASPEECH_PITCH_MEAN,
                                                        XVASPEECH_PITCH_STD, normalize_pitch)

    assert (XVASPEECH_PITCH_MEAN, XVASPEECH_PITCH_STD) == (jax_ds.XVASPEECH_PITCH_MEAN,
                                                            jax_ds.XVASPEECH_PITCH_STD)
    f0 = np.array([0.0, 80.0, 104.606, 300.0, 0.0], np.float32)
    ref = np.where(f0 > 0, (f0 - jax_ds.XVASPEECH_PITCH_MEAN) / jax_ds.XVASPEECH_PITCH_STD,
                   0.0).astype(np.float32)
    assert np.array_equal(normalize_pitch(f0), ref)
