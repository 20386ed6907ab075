"""Port parity: the spline and the xVAPitch submodules, ``infer`` and
``voice_conversion`` against the JAX package, at the TINY size of
tests/test_xvapitch.py (with the reversal classifier off), on the same
weights: the JAX module is initialised from a fixed key, its zero-initialised
leaves are replaced by seeded noise, and ``interop.convert`` carries the
parameters across in fp32. Tolerance: 1e-3 mean L1 (the spline: 1e-4 max);
``infer`` durations and lengths must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_xvapitch import TINY as JAX_TINY

from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu.models.xvapitch.modules import ReversalClassifier as JaxReversalClassifier
from xva_trainer_tpu.ops.spline import rational_quadratic_spline as jax_spline
from xva_trainer_tpu_torch.interop.convert import xvapitch_state_dict
from xva_trainer_tpu_torch.interop.xvapitch_map import rules_for_config
from xva_trainer_tpu_torch.models.xvapitch import XVAPitch, XVAPitchConfig
from xva_trainer_tpu_torch.ops.spline import rational_quadratic_spline as torch_spline

TOL = 1e-3
# both noise scales at 0: synthesis is deterministic on both sides
JCFG = dataclasses.replace(JAX_TINY, mltts_rc=False, inference_noise_scale_dp=0.0)
TCFG = XVAPitchConfig(**dataclasses.asdict(JCFG))
LATENT, LANG = TCFG.latent_size, TCFG.lang_emb_dim


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _init_args(B=1, Tt=8, Ts=40):
    return (jnp.ones((B, Tt), jnp.int32), jnp.full((B,), Tt), jnp.zeros((B, Ts, 513)),
            jnp.full((B,), Ts), jnp.zeros((B, 1, Ts)), jnp.zeros((B, Ts)),
            jnp.zeros((B, Ts * 256, 1)), jnp.zeros((B, 512)), jnp.zeros((B,), jnp.int32))


RNGS = {k: jax.random.PRNGKey(i) for i, k in enumerate(["params", "noise", "segments", "dropout"])}


def _perturb_zeros(tree, rng):
    """Replace all-zero leaves (biases, zero-initialised flows) by N(0, 0.1)
    so that every parameter is exercised."""
    if isinstance(tree, dict):
        return {k: _perturb_zeros(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if not a.any():
        a = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def models():
    params = jax.jit(JaxXVAPitch(JCFG).init)(RNGS, *_init_args())
    pnp = {"params": _perturb_zeros(jax.device_get(params["params"]),
                                    np.random.default_rng(0))}
    # shift the SDP's last reverse step so that log-durations sit near 1 and
    # the ceil'd durations differ from token to token
    pnp["params"]["duration_predictor"]["flows_0"]["m"] = np.array([-1.0, 0.0], np.float32)
    port = XVAPitch(TCFG).eval()
    port.load_state_dict(xvapitch_state_dict(pnp, TCFG), strict=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, pnp)
    return JaxXVAPitch(JCFG), jparams, port


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _cf(x):
    """JAX channels-last (B, T, C) → channels-first numpy (B, C, T)."""
    return np.asarray(x).transpose(0, 2, 1)


def _l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).mean())


def _inputs(seed, B=2, T=12, C=LATENT + LANG):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    lengths = np.array([T, T - 3])[:B].astype(np.int32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    g = (rng.standard_normal((B, 512)) * 0.3).astype(np.float32)
    return rng, x, lengths, mask, g


# ---------------- spline ----------------


def _spline_inputs(seed, shape=(3, 37), K=10, spread=3.0, param_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * spread).astype(np.float32)
    w = (rng.standard_normal(shape + (K,)) * param_scale).astype(np.float32)
    h = (rng.standard_normal(shape + (K,)) * param_scale).astype(np.float32)
    d = (rng.standard_normal(shape + (K - 1,)) * param_scale).astype(np.float32)
    return x, w, h, d


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("seed,tail_bound,param_scale", [
    (0, 5.0, 1.0), (1, 5.0, 2.0), (2, 2.0, 1.0), (3, 5.0, 0.0)])
def test_spline_matches_jax(inverse, seed, tail_bound, param_scale):
    x, w, h, d = _spline_inputs(seed, param_scale=param_scale)
    ref_y, ref_ld = jax_spline(*(jnp.asarray(a) for a in (x, w, h, d)), inverse=inverse,
                               tail_bound=tail_bound)
    y, ld = torch_spline(*(torch.from_numpy(a) for a in (x, w, h, d)), inverse=inverse,
                         tail_bound=tail_bound)
    assert np.abs(y.numpy() - np.asarray(ref_y)).max() < 1e-4
    assert np.abs(ld.numpy() - np.asarray(ref_ld)).max() < 1e-4
    # linear tails: identity outside [-B, B]
    out = np.abs(x) > tail_bound
    assert np.array_equal(y.numpy()[out], x[out])


def test_spline_round_trip_and_monotone():
    x, w, h, d = (torch.from_numpy(a) for a in _spline_inputs(7, spread=2.0))
    y, ld = torch_spline(x, w, h, d)
    x2, ld_inv = torch_spline(y, w, h, d, inverse=True)
    assert (x2 - x).abs().max() < 1e-4
    assert (ld + ld_inv).abs().max() < 1e-4
    xs = torch.linspace(-4.9, 4.9, 200)[None].expand(3, -1)
    ys, _ = torch_spline(xs, w[:, :1].expand(-1, 200, -1), h[:, :1].expand(-1, 200, -1),
                         d[:, :1].expand(-1, 200, -1))
    assert (ys[:, 1:] > ys[:, :-1]).all()


# ---------------- weights ----------------


@pytest.mark.parametrize("cfg", [JCFG, dataclasses.replace(JCFG, big=True, num_flows=1,
                                                           posterior_layers=2, pitch_layers=2)],
                         ids=["tiny", "big_latent"])
def test_state_dict_covers_every_key(cfg):
    """Every flax leaf is read by exactly one rule, and the converted state
    dict loads the port strictly (shapes only: the JAX model is traced)."""
    tcfg = XVAPitchConfig(**dataclasses.asdict(cfg))
    shapes = jax.eval_shape(JaxXVAPitch(cfg).init, RNGS, *_init_args())["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) + 1.0, shapes)
    leaves = {tuple(getattr(k, "key", k) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    read = []
    for r in rules_for_config(tcfg):
        read.append(r.flax_path)
        if r.scale_path is not None:
            read.append(r.scale_path)
    assert len(read) == len(set(read))
    assert set(read) == leaves

    sd = xvapitch_state_dict({"params": params}, tcfg)
    port = XVAPitch(tcfg)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    # the weight-normed convs carry the legacy weight_g (out, 1, 1) / weight_v
    g = sd["posterior_encoder.enc.in_layers.0.weight_g"]
    assert tuple(g.shape) == (port.posterior_encoder.enc.hidden_channels * 2, 1, 1)


def test_reversal_classifier_is_refused():
    """``mltts_rc`` is not refused: the model builds its language classifier,
    whose weights carry over from the JAX package and whose logits match
    JAX's on the same frames."""
    cfg = dataclasses.replace(JCFG, mltts_rc=True)
    tcfg = XVAPitchConfig(**dataclasses.asdict(cfg))
    params = jax.device_get(jax.jit(JaxXVAPitch(cfg).init)(RNGS, *_init_args())["params"])
    port = XVAPitch(tcfg).eval()
    port.load_state_dict(xvapitch_state_dict({"params": params}, tcfg), strict=True)
    frames = np.random.default_rng(8).standard_normal((2, 9, LATENT)).astype(np.float32)
    ref = JaxReversalClassifier(LATENT, LATENT, tcfg.num_languages).apply(
        {"params": params["reversal_classifier"]}, frames)
    with torch.no_grad():
        ours = port.reversal_classifier(_t(frames))
    assert ours.shape == (2, 9, tcfg.num_languages)
    assert np.abs(ours.numpy() - _np(ref)).max() < 1e-5


# ---------------- submodules ----------------


def test_text_encoder(models):
    jm, jp, port = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 60, (2, 12)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    lang = np.array([5, 2], np.int32)

    def fwd(mdl, tokens, lengths, lang):
        x, _, x_mask = mdl.text_encoder(tokens, lengths, mdl.emb_l(lang), deterministic=True)
        return (x,) + mdl.text_encoder.stats(x, x_mask)

    ref = jm.apply(jp, tokens, lengths, lang, method=fwd)
    with torch.no_grad():
        t_tok, t_len = torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long()
        x, _, x_mask = port.text_encoder(t_tok, t_len, port.emb_l(torch.from_numpy(lang).long()))
        ours = (x,) + port.text_encoder.stats(x, x_mask)
    for r, o in zip(ref, ours):
        assert _l1(o, _cf(r)) < TOL


def test_posterior_encoder(models):
    jm, jp, port = models
    rng = np.random.default_rng(1)
    y = np.abs(rng.standard_normal((2, 40, 513))).astype(np.float32)
    lengths = np.array([40, 29], np.int32)
    g = (rng.standard_normal((2, 512)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def fwd(mdl, y, lengths, g):
        return mdl.posterior_encoder(y, lengths, g=g, rng=key, deterministic=True)[:3]

    z, m, logs = jm.apply(jp, y, lengths, g, method=fwd)
    noise = _np(jax.random.normal(key, m.shape))
    with torch.no_grad():
        oz, om, ologs, _ = port.posterior_encoder(
            _t(_cf(y)), torch.from_numpy(lengths).long(), g=_t(g), noise=_t(_cf(noise)))
    assert _l1(om, _cf(m)) < TOL and _l1(ologs, _cf(logs)) < TOL
    assert _l1(oz, _cf(z)) < TOL


def test_flow_both_directions(models):
    jm, jp, port = models
    rng, _, lengths, mask, g = _inputs(2, T=30)
    z = rng.standard_normal((2, 30, LATENT)).astype(np.float32) * mask

    def fwd(mdl, z, mask, g):
        zp = mdl.flow(z, mask, g=g, deterministic=True)
        return zp, mdl.flow(zp, mask, g=g, reverse=True, deterministic=True)

    zp, zrev = jm.apply(jp, z, mask, g, method=fwd)
    with torch.no_grad():
        ozp = port.flow(_t(_cf(z)), _t(_cf(mask)), g=_t(g))
        ozrev = port.flow(ozp, _t(_cf(mask)), g=_t(g), reverse=True)
    assert _l1(ozp, _cf(zp)) < TOL and _l1(ozrev, _cf(zrev)) < TOL
    assert _l1(ozrev, _cf(z)) < TOL


@pytest.mark.parametrize("noise_scale", [0.0, 0.8])
def test_sdp_reverse(models, noise_scale):
    """The same numpy noise goes through the JAX flows (bound with ``.bind``)
    and the port's."""
    jm, jp, port = models
    rng, x, lengths, mask, g = _inputs(3)
    lang = np.array([5, 2], np.int32)
    z0 = rng.standard_normal((2, 12, 2)).astype(np.float32)

    bound = jm.bind(jp)
    dp = bound.duration_predictor
    lang_emb = bound.emb_l(jnp.asarray(lang))
    h = dp._encode_text(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g), lang_emb, True)
    flows = list(reversed(dp.flows))
    flows = flows[:-2] + [flows[-1]]
    z = jnp.asarray(z0) * noise_scale
    for flow in flows:
        z = flow(jnp.flip(z, axis=-1), jnp.asarray(mask), g=h, reverse=True,
                 deterministic=True)
    ref = _np(z[..., :1])

    with torch.no_grad():
        ours = port.duration_predictor.reverse(
            _t(_cf(x)), _t(_cf(mask)), g=_t(g),
            lang_emb=port.emb_l(torch.from_numpy(lang).long()),
            noise_scale=noise_scale, noise=_t(_cf(z0)))
    assert _l1(ours, _cf(ref)) < TOL


def test_pitch_predictor(models):
    jm, jp, port = models
    _, x, lengths, _, g = _inputs(4)

    def fwd(mdl, x, lengths, g):
        return mdl.pitch_predictor(x, lengths, speaker_emb=g, deterministic=True)

    ref = jm.apply(jp, x, lengths, g, method=fwd)
    with torch.no_grad():
        ours = port.pitch_predictor(_t(_cf(x)), torch.from_numpy(lengths).long(),
                                    speaker_emb=_t(g))
    assert _l1(ours, _cf(ref)) < TOL


def test_waveform_decoder(models):
    jm, jp, port = models
    rng = np.random.default_rng(5)
    z = rng.standard_normal((1, 16, LATENT)).astype(np.float32)
    g = rng.standard_normal((1, 512)).astype(np.float32)

    def fwd(mdl, z, g):
        return mdl.waveform_decoder(z, g)

    ref = jm.apply(jp, z, g, method=fwd)
    with torch.no_grad():
        ours = port.waveform_decoder(_t(_cf(z)), _t(g))
    assert _l1(ours, _cf(ref)) < TOL
    assert _l1(ours, _cf(ref)) < 1e-3 * float(np.abs(ref).mean())


# ---------------- the model as a whole ----------------


def test_infer(models):
    jm, jp, port = models
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 60, (2, 14)).astype(np.int32)
    tokens[1, 9:] = 0
    dvec = (rng.standard_normal((2, 512)) * 0.3).astype(np.float32)
    lang = np.array([5, 3], np.int32)
    f = jax.jit(functools.partial(jm.apply, method=JaxXVAPitch.infer, max_frames=96))
    ref = f(jp, tokens, dvec, lang, rngs={"noise": jax.random.PRNGKey(3)})
    gen = torch.Generator().manual_seed(3)
    ours = port.infer(torch.from_numpy(tokens).long(), _t(dvec), torch.from_numpy(lang).long(),
                      max_frames=96, generator=gen)
    assert np.array_equal(ours["durations"].numpy(), _np(ref["durations"]))
    assert np.array_equal(ours["y_lengths"].numpy(), np.asarray(ref["y_lengths"]))
    assert len(np.unique(ours["durations"].numpy())) > 2  # durations vary
    wav = _np(ref["wav"])
    assert _l1(ours["wav"], wav) < TOL
    assert _l1(ours["wav"], wav) < 1e-3 * float(np.abs(wav).mean())


def test_draws_need_noise_or_generator(models):
    """No draw reads the global RNG: without the noise tensors and without a
    generator, ``infer`` and ``voice_conversion`` refuse."""
    *_, port = models
    tokens, dvec, lang = torch.ones((1, 6), dtype=torch.long), torch.zeros((1, 512)), \
        torch.tensor([5])
    with pytest.raises(ValueError, match="Generator"):
        port.infer(tokens, dvec, lang, max_frames=32)
    with pytest.raises(ValueError, match="Generator"):
        port.voice_conversion(torch.ones((1, 513, 8)), torch.tensor([8]), dvec + 1, dvec + 1)


def test_voice_conversion(models):
    jm, jp, port = models
    rng = np.random.default_rng(7)
    linear = np.abs(rng.standard_normal((1, 24, 513))).astype(np.float32)
    lengths = np.array([24], np.int32)
    src = rng.standard_normal((1, 512)).astype(np.float32)
    tgt = rng.standard_normal((1, 512)).astype(np.float32)
    rngs = {"noise": jax.random.PRNGKey(9)}
    ref = jm.apply(jp, linear, lengths, src, tgt, method=JaxXVAPitch.voice_conversion,
                   rngs=rngs)

    # the posterior's draw under the same RNG stream: z = m + n * exp(logs)
    def post(mdl, linear, lengths, src):
        g = src / jnp.maximum(jnp.linalg.norm(src, axis=-1, keepdims=True), 1e-8)
        return mdl.posterior_encoder(linear, lengths, g=g, deterministic=True)[:3]

    z, m, logs = (_np(a) for a in jm.apply(jp, linear, lengths, src, method=post, rngs=rngs))
    noise = (z - m) * np.exp(-logs)
    ours = port.voice_conversion(_t(_cf(linear)), torch.from_numpy(lengths).long(), _t(src),
                                 _t(tgt), noise=_t(_cf(noise)))
    ref = _np(ref)
    assert ours.shape == ref.shape == (1, 24 * 256)
    assert _l1(ours, ref) < TOL
    assert _l1(ours, ref) < 1e-3 * float(np.abs(ref).mean())
