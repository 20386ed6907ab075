"""Shared set-up of the port's v3 training parity tests (not a test module):
the tiny xVAPitch config of tests/test_fused_gd.py, a seeded batch shaped
like ``XvaBatcher(device_spec=True)``'s, seeded JAX parameters, and the
draws of a JAX ``train_step`` recovered so that the port can be fed the same
ones."""
import copy
import dataclasses
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from xva_trainer_tpu.models.xvapitch import VitsDiscriminator as JaxVitsDiscriminator
from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu.models.xvapitch import XVAPitchConfig as JaxXVAPitchConfig
from xva_trainer_tpu.models.xvapitch import losses as jax_losses
from xva_trainer_tpu.train.xvapitch_trainer import V3State, _materialize_spec
from xva_trainer_tpu.train.xvapitch_trainer import make_v3_step as jax_make_v3_step
from xva_trainer_tpu_torch.interop.convert import (train_state_dicts, vits_disc_state_dict,
                                                   xvapitch_state_dict)
from xva_trainer_tpu_torch.interop.xvapitch_map import unused_torch_defaults
from xva_trainer_tpu_torch.models.xvapitch import VitsDiscriminator, XVAPitch, XVAPitchConfig
from xva_trainer_tpu_torch.train.xvapitch_trainer import make_v3_step

B, T_TEXT, T_SPEC, HOP = 2, 24, 64, 256
JCFG = JaxXVAPitchConfig(
    n_vocab=524, big=False, upsample_initial_channel=32, resblock_kernel_sizes=(3,),
    spec_segment_size=8, mltts_rc=False, text_layers=2, posterior_layers=3, flow_wn_layers=2,
    num_flows=2, sdp_flows=2, pitch_layers=1)
TCFG = XVAPitchConfig(**dataclasses.asdict(JCFG))
SEG = JCFG.spec_segment_size * HOP
RNGS = {k: jax.random.PRNGKey(i) for i, k in enumerate(["params", "noise", "segments", "dropout"])}
KEY = jax.random.PRNGKey(3)  # the step's key
LR = 1e-3
UNUSED = set(unused_torch_defaults(TCFG.pitch_layers))


def batch_np(seed=0):
    """A v3 batch (numpy): int16 audio (B, T_SPEC*HOP, 1), tokens, lengths,
    normalised pitch with unvoiced (zero) frames, energy, d-vectors, language
    ids. The audio is a tone plus noise, so that a segment of it is found at
    one place only."""
    rng = np.random.default_rng(seed)
    t = np.arange(T_SPEC * HOP) / 22050
    wav = np.stack([0.4 * np.sin(2 * np.pi * (140 + 50 * i) * t) for i in range(B)])
    wav = wav + 0.02 * rng.standard_normal(wav.shape)
    pitch = rng.standard_normal((B, 1, T_SPEC)).astype(np.float32)
    pitch[rng.random(pitch.shape) < 0.3] = 0.0
    return {
        "tokens": rng.integers(1, 500, (B, T_TEXT)).astype(np.int32),
        "tlens": np.array([T_TEXT, T_TEXT - 4], np.int32),
        "slens": np.array([T_SPEC, T_SPEC - 8], np.int32),
        "pitch": pitch,
        "energy": rng.standard_normal((B, T_SPEC)).astype(np.float32),
        "wav": np.round(np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[..., None],
        "dvec": (rng.standard_normal((B, 512)) * 0.1).astype(np.float32),
        "lang": np.array([5, 2], np.int32),
    }


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b, device="cpu"):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in b.items()}
    for k in ("tokens", "tlens", "slens", "lang"):
        out[k] = out[k].long()
    return out


def _seeded(shapes, seed):
    """Seeded values for a tree of parameter shapes, by leaf name: kernels
    N(0, 1/fan_in), weight-norm and LayerNorm scales 1 + N(0, 0.1), the rest
    (biases, embeddings, affine flows) N(0, 0.1), so that every parameter,
    zero-initialised ones included, is exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            std = 1.0 / math.sqrt(max(1, int(np.prod(s.shape[:-1]))))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def seeded_params(seed=0):
    """(generator params, discriminator params) as numpy trees, each under a
    top-level "params" key, from shapes traced without compiling."""
    lin, wav = _materialize_spec(jax_batch(batch_np()), hop=HOP)
    b = jax_batch(batch_np())
    g_shapes = jax.eval_shape(JaxXVAPitch(JCFG).init, RNGS, b["tokens"], b["tlens"], lin,
                              b["slens"], b["pitch"], b["energy"], wav, b["dvec"], b["lang"])
    seg = jnp.zeros((B, SEG, 1))
    d_shapes = jax.eval_shape(JaxVitsDiscriminator().init, jax.random.PRNGKey(9), seg, seg)
    return _seeded(g_shapes, seed), _seeded(d_shapes, seed + 1)


def port_models(g_params, d_params):
    """The port's XVAPitch and VitsDiscriminator (eval mode: no dropout) on
    the same weights."""
    g_sd, d_sd = train_state_dicts(g_params, d_params, TCFG)
    model = XVAPitch(TCFG).eval()
    model.load_state_dict(g_sd, strict=True)
    disc = VitsDiscriminator().eval()
    disc.load_state_dict(d_sd, strict=True)
    return model, disc


def step_rngs(key):
    """The RNG streams of the JAX ``make_v3_step`` for step key ``key``."""
    return {"noise": jax.random.fold_in(key, 0), "segments": jax.random.fold_in(key, 1),
            "dropout": jax.random.fold_in(key, 2)}


def deterministic(next_fun, args, kwargs, context):
    """flax interceptor: run ``train_step``/``train_hifi_only`` with dropout
    off."""
    if context.method_name in ("train_step", "train_hifi_only"):
        kwargs = {**kwargs, "deterministic": True}
    return next_fun(*args, **kwargs)


def _sow_draws(next_fun, args, kwargs, context):
    """flax interceptor: record the input of the SDP's first posterior flow,
    which is its noise times x_mask, and the posterior encoder's z."""
    if context.method_name == "__call__" and context.module.name == "post_flows_0":
        context.module.sow("intermediates", "sdp_noise", args[0])
    out = next_fun(*args, **kwargs)
    if context.method_name == "__call__" and context.module.name == "posterior_encoder":
        context.module.sow("intermediates", "z", out[0])
    return out


def _find(tree, name):
    if isinstance(tree, dict):
        for k, v in tree.items():
            found = v[0] if k == name else _find(v, name)
            if found is not None:
                return found
    return None


def jax_forward(g_params, d_params, b, key=KEY, hifi_only=False):
    """The JAX train_step (dropout off) under the step's RNG streams, its
    generator-loss components, and the SDP's recorded noise."""
    model, disc = JaxXVAPitch(JCFG), JaxVitsDiscriminator()

    @jax.jit
    def run(g_params, d_params, b):
        lin, wav = _materialize_spec(b, hop=HOP)
        if hifi_only:
            out, inter = model.apply(g_params, lin, b["slens"], wav, b["dvec"],
                                     method=JaxXVAPitch.train_hifi_only, deterministic=True,
                                     rngs=step_rngs(key), mutable=["intermediates"])
        else:
            out, inter = model.apply(g_params, b["tokens"], b["tlens"], lin, b["slens"],
                                     b["pitch"], b["energy"], wav, b["dvec"], b["lang"],
                                     method=JaxXVAPitch.train_step, deterministic=True,
                                     rngs=step_rngs(key), mutable=["intermediates"])
        s_fake, f_fake, s_real, f_real = disc.apply(d_params, out["model_outputs"],
                                                    out["waveform_seg"])
        g_loss, meta = jax_losses.generator_loss(out, s_fake, f_fake, f_real,
                                                 language_ids=b["lang"],
                                                 spec_lengths=b["slens"], hifi_only=hifi_only)
        d_loss, _ = jax_losses.discriminator_loss(s_real, s_fake)
        meta = dict(meta, loss_disc=d_loss)
        return out, meta, inter

    with nn.intercept_methods(_sow_draws):
        out, meta, inter = run(g_params, d_params, jax_batch(b))
    out = {k: (None if v is None else np.asarray(v)) for k, v in out.items()}
    out["z"] = np.asarray(_find(inter, "z"))
    meta = {k: np.asarray(v) for k, v in meta.items()}
    sdp_noise = _find(inter, "sdp_noise")
    return out, meta, (None if sdp_noise is None else np.asarray(sdp_noise))


def draws_of(out, b, sdp_noise=None):
    """The port's draws that reproduce a JAX train_step: the posterior's noise
    (z - m_q)·exp(-logs_q), the SDP's recorded noise, and a segment draw u
    whose start floor(u·(max_start+1)) is the one found in waveform_seg (of
    int16 or float audio)."""
    def cf(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 2, 1)))

    draws = {"noise": cf((out["z"] - out["m_q"]) * np.exp(-out["logs_q"]))}
    wav = b["wav"][..., 0].astype(np.float32)
    if b["wav"].dtype == np.int16:  # dequantised as the step does
        wav = wav * np.float32(1.0 / 32767.0)
    seg = np.asarray(out["waveform_seg"])[..., 0]
    u = []
    for i in range(len(b["slens"])):
        max_start = max(int(b["slens"][i]) - JCFG.spec_segment_size, 0)
        errs = [np.abs(wav[i, s * HOP: s * HOP + SEG] - seg[i]).max()
                for s in range(max_start + 1)]
        start = int(np.argmin(errs))
        assert errs[start] == 0.0 and sorted(errs)[1] > 0.0 if max_start else True
        u.append((start + 0.5) / (max_start + 1))
    draws["seg_u"] = torch.tensor(u, dtype=torch.float32)
    if sdp_noise is not None:
        draws["dp_noise"] = cf(sdp_noise)
    return draws


def rel_err(ours, ref) -> float:
    """max |ours - ref| / max |ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


class Sgd:
    """optax.sgd (with optional decoupled weight decay, as
    ``optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr))``) in the
    port's optimiser interface."""

    def __init__(self, params, lr=LR, weight_decay=0.0):
        self.params, self.lr, self.wd = list(params), lr, weight_decay

    @torch.no_grad()
    def step(self, grads, apply_mask=None):
        for i, (p, g) in enumerate(zip(self.params, grads)):
            u = -self.lr * ((0 if g is None else g) + self.wd * p)
            if apply_mask is None or apply_mask[i]:
                p.add_(u)
        return True


def port_sds(model, disc):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: v.detach().clone() for k, v in disc.state_dict().items()})


def assert_updates_match(old, new, j_old, j_new):
    """For every parameter: its update (new - old) on the port within 1e-3 of
    the JAX update's max abs (both in the port's layout), plus 1e-6 of the
    largest JAX update of the model (the float noise of a gradient that is
    zero in exact arithmetic) and 2 ulp of the parameter's largest value (the
    finest difference new - old resolves in fp32)."""
    refs = {k: j_new[k].numpy() - j_old[k].numpy() for k in j_new if k not in UNUSED}
    floor = 1e-6 * max(np.abs(r).max() for r in refs.values())
    assert set(refs) == set(new) - UNUSED
    for k, v in new.items():
        if k in UNUSED:  # the pitch transformer's unused last norm: no JAX parameter
            continue
        ours = (v - old[k]).numpy()
        ulp2 = 2 * np.finfo(np.float32).eps * float(old[k].abs().max())
        assert np.abs(ours - refs[k]).max() <= 1e-3 * np.abs(refs[k]).max() + floor + ulp2, k


def run_both_steps(case, *, fused=True, jax_tx=None, port_opt=Sgd, freeze_post_dec=False,
                   hifi_only=False):
    """One JAX make_v3_step and one port make_v3_step from the same state,
    batch and draws (the JAX step with dropout off, the port's models in
    eval mode). Returns the JAX meta, the port meta, the port's (generator,
    discriminator) state dicts before and after, the JAX ones before and
    after in the port's layout, and the JAX step's new state."""
    g_params, d_params, b, _, _, draws = case
    jax_tx = jax_tx or (lambda: optax.sgd(LR))
    model, disc = JaxXVAPitch(JCFG), JaxVitsDiscriminator()
    g_tx, d_tx = jax_tx(), jax_tx()
    step = jax_make_v3_step(model, disc, g_tx, d_tx, freeze_post_dec=freeze_post_dec,
                            hifi_only=hifi_only, use_amp=False, fused_gd=fused)
    gp, dp = (jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(p)) for p in (g_params, d_params))
    state = V3State(g_params=gp, d_params=dp, g_opt=g_tx.init(gp), d_opt=d_tx.init(dp),
                    step=jnp.zeros((), jnp.int32))
    with nn.intercept_methods(deterministic):
        new_state, j_meta = step(state, jax_batch(b), KEY)
    j_old = (xvapitch_state_dict(g_params, TCFG), vits_disc_state_dict(d_params))
    j_new = (xvapitch_state_dict(jax.device_get(new_state.g_params), TCFG),
             vits_disc_state_dict(jax.device_get(new_state.d_params)))

    pm, pd = port_models(g_params, d_params)
    old = port_sds(pm, pd)
    p_step = make_v3_step(pm, pd, port_opt(pm.parameters()), port_opt(pd.parameters()),
                          freeze_post_dec=freeze_post_dec, hifi_only=hifi_only, use_amp=False)
    p_meta = p_step(torch_batch(b), **draws)
    new = port_sds(pm, pd)
    return ({k: np.asarray(v) for k, v in j_meta.items()}, p_meta, old, new, j_old, j_new,
            new_state)


# ---------------- the v2 (FastPitch) tests' set-up ----------------

def fastpitch_configs():
    """(JAX, port) FastPitchConfig at the small width of the v2 parity tests:
    2 + 2 layers, 64 wide, filters 128, no dropout."""
    from xva_trainer_tpu.models.fastpitch import FastPitchConfig as JaxFastPitchConfig
    from xva_trainer_tpu_torch.models.fastpitch import FastPitchConfig

    kw = dict(symbols_embedding_dim=64, in_fft_n_layers=2, out_fft_n_layers=2,
              in_fft_d_head=32, out_fft_d_head=32, in_fft_filter_size=128,
              out_fft_filter_size=128, predictor_filter_size=128, p_fft_dropout=0.0,
              p_fft_dropatt=0.0, p_predictor_dropout=0.0)
    return JaxFastPitchConfig(**kw), FastPitchConfig(**kw)


def seeded_fastpitch(jcfg, seed=0, t_text=12, t_mel=40):
    """Seeded JAX FastPitch parameters (numpy, under "params"), shapes traced
    with ``jax.eval_shape`` (no init program is compiled). The duration
    predictor's output bias is 1.6, so that inference predicts about 4
    frames a token (small seeded weights alone predict none)."""
    from xva_trainer_tpu.models.fastpitch import FastPitch as JaxFastPitch

    z = jnp.zeros
    shapes = jax.eval_shape(
        JaxFastPitch(jcfg).init, jax.random.PRNGKey(0), z((1, t_text), jnp.int32),
        jnp.ones((1,), jnp.int32), z((1, t_mel, 80)), jnp.ones((1,), jnp.int32),
        z((1, 1, t_mel)), z((1, t_mel)), z((1, t_mel, t_text)))
    params = _seeded(shapes, seed)
    bias = params["params"]["duration_predictor"]["Dense_0"]["bias"]
    params["params"]["duration_predictor"]["Dense_0"]["bias"] = np.full_like(bias, 1.6)
    return params


def port_fastpitch(jax_params, cfg):
    """The port's FastPitch with ``jax_params`` carried in (strict), fp32, eval."""
    from xva_trainer_tpu_torch.interop.convert import fastpitch_state_dict
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch

    model = FastPitch(cfg)
    model.load_state_dict(fastpitch_state_dict(jax_params, cfg), strict=True)
    return model.eval()
