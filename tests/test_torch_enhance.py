"""The port's speech enhancer (``xva_trainer_tpu_torch/models/enhance``)
held to the JAX package's on the same inputs and weights: the shipped
``assets/enhancer_default.npz`` (a byte copy in each package) and a seeded
flax initialisation carried across by ``interop/convert.py::
enhancer_state_dict``.

``ComplexMaskNet`` and ``SpeechEnhancer.enhance`` within 1e-5 max abs (F =
257, a frame count that is not a multiple of 8; a 9 s clip: three chunks
and two crossfades; a 0.5 s clip), ``si_sdr`` within 1e-6 dB; the bars of
JAX's ``tests/test_enhance_default.py`` (mean SI-SDR gain over 6 dB and
over the spectral gate + 2 dB); one ``train_enhancer`` AdamW step from the
same parameters and segments within 1e-5 (relative, L2) of optax's; and a
short run that raises SI-SDR, as JAX's ``tests/test_enhance.py``.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xva_trainer_tpu.models.enhance import model as jmodel
from xva_trainer_tpu.tools.text_tools import default_enhancer_path as jax_default
from xva_trainer_tpu_torch.interop.convert import enhancer_state_dict
from xva_trainer_tpu_torch.models.enhance import model as pmodel
from xva_trainer_tpu_torch.models.enhance.synth import SR, make_pair
from xva_trainer_tpu_torch.tools.text_tools import SourceSeparationTool, default_enhancer_path

TINY = dict(n_fft=256, hop=64, base_channels=8, depth=2)


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shipped():
    """(JAX params, the port's state dict) of the shipped weights, each
    package reading its own copy."""
    return jmodel.load_params_npz(jax_default()), pmodel.load_params_npz(default_enhancer_path())


def test_shipped_weights_are_a_copy():
    with open(jax_default(), "rb") as a, open(default_enhancer_path(), "rb") as b:
        assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest()
    sd = pmodel.load_params_npz(default_enhancer_path())
    assert sum(v.numel() for v in sd.values()) == 2_016_794
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("weights", ["shipped", "seeded"])
def test_mask_net_matches_jax(weights, shipped):
    cfg = jmodel.EnhanceConfig()
    if weights == "shipped":
        params, sd = shipped
    else:
        params = numpy_tree(jmodel.ComplexMaskNet(cfg).init(jax.random.PRNGKey(3),
                                                             jnp.zeros((1, 8, 257, 2))))
        sd = enhancer_state_dict(params)
    x = np.random.default_rng(1).standard_normal((2, 45, 257, 2)).astype(np.float32)
    want = np.asarray(jmodel.ComplexMaskNet(cfg).apply(params, jnp.asarray(x)))
    net = pmodel.ComplexMaskNet(pmodel.EnhanceConfig())
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 45, 257, 2)
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("seconds", [9.0, 0.5])
def test_enhance_matches_jax(seconds, shipped):
    params, sd = shipped
    noisy, _ = make_pair(seconds, 5.0, np.random.default_rng(int(seconds * 10)))
    want = jmodel.SpeechEnhancer(params).enhance(noisy)
    enh = pmodel.SpeechEnhancer(sd, device="cpu")
    assert enh.chunk == 88192 and (seconds < 4 or len(noisy) > 2 * enh.chunk)
    got = enh.enhance(noisy)
    assert got.shape == want.shape == noisy.shape and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-5


def test_si_sdr_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((3, 4000)).astype(np.float32)
    est = (ref + 0.3 * rng.standard_normal((3, 4000))).astype(np.float32)
    want = np.asarray(jmodel.si_sdr(jnp.asarray(est), jnp.asarray(ref)))
    got = pmodel.si_sdr(torch.from_numpy(est), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_shipped_weights_beat_the_gate(shipped, monkeypatch):
    """JAX's bars on held-out synthetic noisy speech, held by the port; the
    'ass' tool loads the shipped weights by default."""
    monkeypatch.delenv("XVA_ASS_CKPT", raising=False)
    monkeypatch.setattr(SourceSeparationTool, "_model_backend", None)
    monkeypatch.setattr(SourceSeparationTool, "_enhancers", {})
    tool = SourceSeparationTool(device="cpu")
    assert tool._load_learned(None) is not None
    assert list(SourceSeparationTool._enhancers) == [(default_enhancer_path(), "cpu")]
    enh = pmodel.SpeechEnhancer(shipped[1], device="cpu")
    rng = np.random.default_rng(777)
    gains_model, gains_gate = [], []
    for _ in range(3):
        noisy, clean = make_pair(3.0, 5.0, rng)
        est = enh.enhance(noisy)
        gate = SourceSeparationTool._spectral_gate(noisy)
        L = min(len(est), len(clean), len(gate))

        def sdr(y):
            return float(pmodel.si_sdr(torch.from_numpy(y[:L]), torch.from_numpy(clean[:L])))

        base = sdr(noisy)
        gains_model.append(sdr(est) - base)
        gains_gate.append(sdr(gate) - base)
    assert np.mean(gains_model) > 6.0, (gains_model, gains_gate)
    assert np.mean(gains_model) > np.mean(gains_gate) + 2.0, (gains_model, gains_gate)


def _pair(seed=0, n=SR * 4):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    clean = 0.4 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
    noise = 0.25 * rng.standard_normal(n)
    return (clean + noise).astype(np.float32), clean.astype(np.float32)


def test_train_step_matches_optax():
    """One AdamW step (optax's adamw: weight decay 1e-4) from JAX's seed-0
    initialisation on the same segments: the loss within 1e-5 relative,
    the parameters within 1e-5 of their norm (L2 over all of them)."""
    noisy, clean = _pair()
    jcfg = jmodel.EnhanceConfig(**TINY)
    init = numpy_tree(jmodel.SpeechEnhancer(None, jcfg).params)
    params, jlosses = jmodel.train_enhancer(noisy, clean, jcfg, steps=1, segment=8192, batch=2)
    sd, losses = pmodel.train_enhancer(noisy, clean, pmodel.EnhanceConfig(**TINY), steps=1,
                                       segment=8192, batch=2, state_dict=enhancer_state_dict(init),
                                       device="cpu")
    assert abs(losses[0] - jlosses[0]) <= 1e-5 * abs(jlosses[0])
    want = enhancer_state_dict(numpy_tree(params))
    before = enhancer_state_dict(init)
    diff = sum(float(((sd[k] - want[k]) ** 2).sum()) for k in want) ** 0.5
    norm = sum(float((want[k] ** 2).sum()) for k in want) ** 0.5
    moved = sum(float(((want[k] - before[k]) ** 2).sum()) for k in want) ** 0.5
    assert diff <= 1e-5 * norm and moved > 100 * diff, (diff, norm, moved)


def test_training_improves_si_sdr():
    noisy, clean = _pair()
    cfg = pmodel.EnhanceConfig(**TINY)
    base = float(pmodel.si_sdr(torch.from_numpy(noisy), torch.from_numpy(clean)))
    sd, losses = pmodel.train_enhancer(noisy, clean, cfg, steps=40, segment=8192, batch=2,
                                       device="cpu")
    assert losses[-1] < losses[0]
    out = pmodel.SpeechEnhancer(sd, cfg, chunk_seconds=0.4, device="cpu").enhance(noisy[:SR])
    improved = float(pmodel.si_sdr(torch.from_numpy(out), torch.from_numpy(clean[:SR])))
    assert improved > base + 1.0


def test_needs_a_card_unless_told_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmodel.SpeechEnhancer()
