"""The port's WaveGlow (``xva_trainer_tpu_torch/models/waveglow``) against
the JAX package's at ``tests/test_waveglow.py``'s tiny config, on the same
weights (seeded flax parameters carried by ``interop/convert.py::
waveglow_state_dict``; each 1×1 conv's W orthogonal, the couplings' end
layers scaled down, so that every flow is invertible and non-trivial):

- ``infer`` fed JAX's own noise draws (recorded as JAX makes them), and
  the training direction ``forward``: within 1e-4 of the output's max abs;
- the denoiser at strengths 0, 0.1 and 1: within 1e-4 of the max abs;
- JAX's three properties, on the port's own initialisation: the shape of
  ``infer``, the denoiser's bias removal, the forward/inverse round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_v3_common import _seeded

from xva_trainer_tpu.models.waveglow import WaveGlow as JaxWaveGlow
from xva_trainer_tpu.models.waveglow import WaveGlowConfig as JaxWaveGlowConfig
from xva_trainer_tpu.models.waveglow.model import WaveGlowDenoiser as JaxDenoiser
from xva_trainer_tpu_torch.interop.convert import waveglow_state_dict
from xva_trainer_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig, WaveGlowDenoiser

KW = dict(n_flows=4, wn_layers=2, wn_channels=32, hop_length=256)
JTINY, TINY = JaxWaveGlowConfig(**KW), WaveGlowConfig(**KW)
T_MEL = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def close(ours, ref, tol=1e-4):
    ours = ours.detach().double().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1.0), err


@pytest.fixture(scope="module")
def weights():
    model = JaxWaveGlow(JTINY)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)},
                            jnp.zeros((1, T_MEL, 80)))
    params = _seeded(shapes, 0)
    rng = np.random.default_rng(1)
    for name, p in params["params"].items():
        if name.startswith("convs_"):
            q = np.linalg.qr(rng.standard_normal(p["W"].shape))[0]
            if np.linalg.det(q) < 0:
                q[:, 0] = -q[:, 0]
            p["W"] = q.astype(np.float32)
        if name.startswith("couplings_"):
            p["end"]["kernel"] = p["end"]["kernel"] * np.float32(0.05)
    port = WaveGlow(TINY)
    port.load_state_dict(waveglow_state_dict(params, TINY), strict=True)
    return model, params, port.eval()


def jax_infer_with_draws(model, params, mel, sigma, monkeypatch):
    """JAX's infer, and its normal draws in the order it made them."""
    drawn = []
    real = jax.random.normal

    def record(*a, **k):
        drawn.append(np.asarray(real(*a, **k)))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "normal", record)
    out = model.apply(params, jnp.asarray(mel), sigma, rngs={"noise": jax.random.PRNGKey(2)})
    monkeypatch.setattr(jax.random, "normal", real)
    return np.asarray(out), [torch.from_numpy(np.array(d)) for d in drawn]


@pytest.mark.parametrize("sigma", [1.0, 0.6])
def test_infer_matches_jax(weights, sigma, monkeypatch):
    model, params, port = weights
    mel = np.random.default_rng(0).standard_normal((2, T_MEL, 80)).astype(np.float32)
    ref, drawn = jax_infer_with_draws(model, params, mel, sigma, monkeypatch)
    assert len(drawn) == 1  # four flows: no early exit before the last
    with torch.no_grad():
        ours = port.infer(torch.from_numpy(mel), sigma, noise=drawn)
    assert ours.shape == (2, T_MEL * 256)
    close(ours, ref)


def test_infer_with_early_exits_matches_jax(monkeypatch):
    """Nine flows: two early exits, so three draws, consumed in JAX's order."""
    kw = dict(KW, n_flows=9)
    jcfg, cfg = JaxWaveGlowConfig(**kw), WaveGlowConfig(**kw)
    model = JaxWaveGlow(jcfg)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 4, 80)))
    params = _seeded(shapes, 3)
    for name, p in params["params"].items():
        if name.startswith("convs_"):
            p["W"] = np.eye(p["W"].shape[0], dtype=np.float32)[::-1].copy()
        if name.startswith("couplings_"):
            p["end"]["kernel"] = p["end"]["kernel"] * np.float32(0.05)
    port = WaveGlow(cfg).eval()
    port.load_state_dict(waveglow_state_dict(params, cfg), strict=True)
    mel = np.random.default_rng(1).standard_normal((1, 4, 80)).astype(np.float32)
    ref, drawn = jax_infer_with_draws(model, params, mel, 1.0, monkeypatch)
    assert [d.shape[-1] for d in drawn] == [4, 2, 2]
    with torch.no_grad():
        close(port.infer(torch.from_numpy(mel), 1.0, noise=drawn), ref)


def test_forward_matches_jax(weights):
    model, params, port = weights
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, T_MEL, 80)).astype(np.float32)
    audio = (0.3 * rng.standard_normal((2, T_MEL * 256, 1))).astype(np.float32)
    z, logdet = model.apply(params, jnp.asarray(audio), jnp.asarray(mel),
                            method=JaxWaveGlow.forward)
    with torch.no_grad():
        oz, ol = port.forward(torch.from_numpy(audio), torch.from_numpy(mel))
    close(oz, z)
    close(ol, logdet)


def test_denoiser_matches_jax(weights):
    model, params, port = weights
    den_j = JaxDenoiser(model.apply, params, frames=T_MEL)
    den_p = WaveGlowDenoiser(port, frames=T_MEL)
    close(den_p.bias_spec, den_j.bias_spec)
    audio = np.random.default_rng(4).standard_normal(T_MEL * 256).astype(np.float32) * 0.2
    for strength in (0.0, 0.1, 1.0):
        close(den_p(torch.from_numpy(audio), strength), den_j(jnp.asarray(audio), strength))


# ---- JAX's own properties (tests/test_waveglow.py), on the port ----


@pytest.fixture(scope="module")
def fresh():
    torch.manual_seed(0)
    return WaveGlow(TINY).eval()


def test_infer_shape(fresh):
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 80)).astype(np.float32))
    with torch.no_grad():
        wav = fresh.infer(mel, generator=torch.Generator().manual_seed(2))
    assert wav.shape == (2, 8 * 256)
    assert torch.isfinite(wav).all()


def test_denoiser_removes_bias(fresh):
    den = WaveGlowDenoiser(fresh, frames=8)
    with torch.no_grad():
        bias_audio = fresh.infer(torch.zeros((1, 8, 80)), 0.0,
                                 generator=torch.Generator().manual_seed(0))[0]
    out_full, out_zero = den(bias_audio, strength=1.0), den(bias_audio, strength=0.0)
    e = float((bias_audio ** 2).sum())
    assert float((out_full ** 2).sum()) < 0.9 * e or e < 1e-10
    n = min(len(out_zero), bias_audio.shape[-1]) - 512
    assert torch.allclose(out_zero[256:n], bias_audio[256:n], atol=1e-3)


def test_forward_inverse_consistency(fresh):
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 80)).astype(np.float32))
    with torch.no_grad():
        audio = fresh.infer(mel, 1.0, generator=torch.Generator().manual_seed(3))
        z, logdet = fresh.forward(audio[..., None], mel)
    assert torch.isfinite(z).all() and torch.isfinite(logdet).all()
    assert 0.5 < float(z.std()) < 2.0
