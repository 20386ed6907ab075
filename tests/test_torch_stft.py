"""Port parity: spectrogram ops and the fused STFT kernel's plain version
(xva_trainer_tpu_torch.ops) against the JAX package on the same inputs.

The JAX Pallas kernel runs in interpret mode on the CPU, on inputs of at
most one 128-frame block. Tolerance: 1e-3 mean L1 (the repo's spectrogram
bar, BASELINE.md).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xva_trainer_tpu.ops import stft as jstft
from xva_trainer_tpu.ops.pallas_stft import mel_spectrogram_pallas
from xva_trainer_tpu_torch.ops import _cuda
from xva_trainer_tpu_torch.ops import fused_stft as fs
from xva_trainer_tpu_torch.ops import stft as tstft

TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _audio(b=2, T=8192, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050.0
    sig = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t)
    return np.clip(sig + 0.05 * rng.standard_normal((b, T)), -1, 1).astype(np.float32)


def _l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).mean())


# the five cases of tests/test_stft.py: Tacotron, HiFi-GAN, full band, linear,
# odd length
CASES = {
    "tacotron": ("mel_spectrogram", tstft.DEFAULT_MEL, 22050),
    "hifigan": ("mel_spectrogram_hifigan", tstft.DEFAULT_MEL, 22050),
    "full_band": ("mel_spectrogram_hifigan", tstft.LOSS_MEL, 22050),
    "linear": ("linear_spectrogram", tstft.DEFAULT_MEL, 22050),
    "odd_length": ("mel_spectrogram", tstft.DEFAULT_MEL, 22051),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_stft_ops_match_jax(case, method):
    """The port's one (rfft) path against both of the JAX package's methods."""
    fn, cfg, T = CASES[case]
    jcfg = jstft.MelConfig(fmax=cfg.fmax)
    y = _audio(T=T)
    kw = {} if fn == "linear_spectrogram" else {"method": method}
    ref = getattr(jstft, fn)(jnp.asarray(y), jcfg, **kw)
    ours = getattr(tstft, fn)(torch.from_numpy(y), cfg)
    assert _l1(ours, ref) < TOL


@pytest.mark.parametrize("center", [True, False, None])
def test_stft_magnitude_centers(center):
    y = _audio(T=9000)
    ref = jstft.stft_magnitude(jnp.asarray(y), center=center, mag_eps=1e-9, method="fft")
    ours = tstft.stft_magnitude(torch.from_numpy(y), center=center, mag_eps=1e-9)
    assert _l1(ours, ref) < TOL


def test_window_and_basis_match_jax():
    assert np.array_equal(tstft.hann_window(1024, 1024), jstft.hann_window(1024, 1024))
    assert np.array_equal(tstft.dft_basis(1024, 1024), jstft.dft_basis(1024, 1024))


def test_mel_loss_gradient_matches_jax():
    """The HiFi-GAN log-mel is differentiable, and its gradient (what the mel
    loss back-propagates) matches the JAX package's."""
    y = _audio(T=8192)
    ref = np.asarray(jax.grad(lambda a: jstft.mel_spectrogram_hifigan(a).mean())(
        jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_()
    tstft.mel_spectrogram_hifigan(yt).mean().backward()
    assert _l1(yt.grad, ref) < TOL * float(np.abs(ref).mean())


@pytest.mark.parametrize("algorithm", ["split", "full"])
@pytest.mark.parametrize("center,mag_eps", [(True, 0.0), (False, 1e-9), (None, 0.0)])
@pytest.mark.parametrize("return_linear", [True, False])
def test_fused_matches_pallas(algorithm, center, mag_eps, return_linear):
    y = _audio()  # 33 frames: one block of the TPU kernel
    kw = dict(center=center, mag_eps=mag_eps, return_linear=return_linear)
    ref = mel_spectrogram_pallas(jnp.asarray(y), algorithm=algorithm, **kw)
    ours = fs.mel_spectrogram_fused(torch.from_numpy(y), **kw)
    if return_linear:
        assert ours[1].shape[-2] == 513
        assert _l1(ours[0], ref[0]) < TOL
        assert _l1(ours[1], ref[1]) < TOL
    else:
        assert _l1(ours, ref) < TOL


@pytest.mark.parametrize("algorithm", ["split", "full"])
def test_fused_short_and_1d_input(algorithm):
    # shorter than one 128-frame block of the TPU kernel, and (T,) input
    y = _audio(b=1, T=4096)[0]
    ref = mel_spectrogram_pallas(jnp.asarray(y), return_linear=True, algorithm=algorithm)
    mel, lin = fs.mel_spectrogram_fused(torch.from_numpy(y), return_linear=True)
    assert tuple(mel.shape) == (80, 17) and tuple(lin.shape) == (513, 17)
    assert _l1(mel, ref[0]) < TOL and _l1(lin, ref[1]) < TOL


@pytest.mark.parametrize("case", ["tacotron", "hifigan", "linear", "odd_length"])
def test_fused_long_input_matches_jax_plain_path(case):
    """Past one block, the plain fused version against the JAX plain path
    (stft_magnitude, mel basis, log-clamp)."""
    fn, cfg, T = CASES[case]
    y = _audio(T=T * 2)  # 173 frames: more than one 128-frame block
    center, eps = (False, 1e-9) if fn == "mel_spectrogram_hifigan" else (True, 0.0)
    mel, lin = fs.mel_spectrogram_fused(torch.from_numpy(y), cfg, center=center, mag_eps=eps,
                                        return_linear=True)
    if fn == "linear_spectrogram":
        assert _l1(lin, jstft.linear_spectrogram(jnp.asarray(y))) < TOL
    else:
        assert _l1(mel, getattr(jstft, fn)(jnp.asarray(y))) < TOL


@pytest.mark.parametrize("center", [True, None])
def test_fused_hop_128(center):
    # the JAX wrapper computes n_fft//hop != 4 with stft_magnitude; the port's
    # kernel frames any hop
    cfg_j = jstft.MelConfig(hop_length=128)
    cfg_t = tstft.MelConfig(hop_length=128)
    y = _audio(T=6000)
    ref_mel, ref_lin = mel_spectrogram_pallas(jnp.asarray(y), cfg_j, center=center,
                                              return_linear=True)
    mel, lin = fs.mel_spectrogram_fused(torch.from_numpy(y), cfg_t, center=center,
                                        return_linear=True)
    assert _l1(mel, ref_mel) < TOL and _l1(lin, ref_lin) < TOL


_SQRT_HALF = np.float32(np.sqrt(0.5))


def _fft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    return t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3


def _fft8(v):
    """The kernel's radix-8 butterfly: 4-point DFTs of the even and the odd
    inputs, then one radix-2 step."""
    e = _fft4(v[0], v[2], v[4], v[6])
    o = list(_fft4(v[1], v[3], v[5], v[7]))
    o[1] = (_SQRT_HALF * (o[1].real + o[1].imag)
            + 1j * (_SQRT_HALF * (o[1].imag - o[1].real))).astype(np.complex64)
    o[2] = -1j * o[2]
    o[3] = (_SQRT_HALF * (o[3].imag - o[3].real)
            - 1j * (_SQRT_HALF * (o[3].real + o[3].imag))).astype(np.complex64)
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _emulate_kernel(frames, cfg, mag_eps=0.0):
    """The CUDA kernel's algorithm in float32 numpy, on (B, F, 1024) frames,
    with the kernel's own host tables: pack the windowed even/odd samples as
    z[m] = x[2m] + i x[2m+1]; three radix-8 Stockham passes (butterfly j
    takes z[j + 64r], twiddles exp(-2πi r (j % Ns) / 8Ns) from the pass
    table, writes (j // Ns) 8Ns + j % Ns + r Ns); X[k] = E[k] + exp(-2πik/1024) O[k], the
    Nyquist bin Re Z[0] - Im Z[0]; the magnitude; the mel over [lo, hi)
    from the packed weights, in four chains."""
    win, twp, tw1024, melw, span = fs.kernel_consts(cfg)
    twp = (twp[:, 0] + 1j * twp[:, 1]).astype(np.complex64)
    x = frames.astype(np.float32)
    z = (x[..., 0::2] * win[:, 0] + 1j * (x[..., 1::2] * win[:, 1])).astype(np.complex64)
    j = np.arange(64)
    tw = {1: [np.ones(64, np.complex64)] * 8,  # the twiddles of each pass, as the lanes read them
          8: [np.ones(64, np.complex64)] + [twp[8 * (r - 1) + j % 8] for r in range(1, 8)],
          64: [np.ones(64, np.complex64)] + [twp[56 + 64 * (r - 1) + j] for r in range(1, 8)]}
    for ns in (1, 8, 64):
        v = [z[..., j + 64 * r] * tw[ns][r] for r in range(8)]
        out = np.empty_like(z)
        for r, vr in enumerate(_fft8(v)):
            out[..., (j // ns) * ns * 8 + j % ns + r * ns] = vr
        z = out
    c = z[..., (512 - np.arange(512)) % 512]
    er, ei = 0.5 * (z.real + c.real), 0.5 * (z.imag - c.imag)
    orr, oi = 0.5 * (z.imag + c.imag), -0.5 * (z.real - c.real)
    re = er + tw1024[:, 0] * orr - tw1024[:, 1] * oi
    im = ei + tw1024[:, 0] * oi + tw1024[:, 1] * orr
    nyq = z[..., :1].real - z[..., :1].imag
    mag = np.sqrt(np.concatenate([re * re + im * im, nyq * nyq], -1) + np.float32(mag_eps))
    mel = np.zeros(mag.shape[:-1] + (cfg.n_mels,), np.float32)
    for m, (lo, hi, off, _) in enumerate(span):
        acc = np.zeros((4,) + mag.shape[:-1], np.float32)  # the kernel's four chains
        for t in range(hi - lo):
            acc[t % 4 if t < (hi - lo) // 4 * 4 else 0] += melw[off + t] * mag[..., lo + t]
        mel[..., m] = (acc[0] + acc[1]) + (acc[2] + acc[3])
    mel = np.log(np.maximum(mel, np.float32(cfg.clip_val)))
    return mel.transpose(0, 2, 1), mag.transpose(0, 2, 1)


@pytest.mark.parametrize("win_length", [1024, 800])
@pytest.mark.parametrize("hop", [128, 200, 256])
def test_kernel_algorithm_emulation(hop, win_length):
    """Emulate, in float32 numpy, the CUDA kernel's FFT with its host tables
    and hold it against the plain version."""
    cfg = tstft.MelConfig(hop_length=hop, win_length=win_length)
    y = _audio(T=8192)
    yp, nf = fs._prepare(torch.from_numpy(y), cfg, True)
    fr = tstft.frame_signal(yp, 1024, hop, nf).numpy()
    mel, lin = _emulate_kernel(fr, cfg)
    ref_mel, ref_lin = fs.mel_spectrogram_fused_reference(torch.from_numpy(y), cfg,
                                                          return_linear=True)
    assert mel.dtype == np.float32 and lin.shape == tuple(ref_lin.shape)
    assert np.abs(mel - ref_mel.numpy()).max() < 1e-4
    assert np.abs(lin - ref_lin.numpy()).max() < 1e-3


def test_cpu_wrapper_counts_no_launch():
    """A CPU tensor takes the plain version, which is no launch."""
    _cuda.reset_launch_counts()
    y = torch.from_numpy(_audio(T=4096))
    fs.mel_spectrogram_fused(y, return_linear=True)
    fs.mel_spectrogram_fused_reference(y)
    assert _cuda.LAUNCHES == {"fused_stft": 0, "mas": 0}


def test_wrapper_has_no_fallback_for_other_devices():
    y = torch.empty((2, 4096), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fs.mel_spectrogram_fused(y)
    with pytest.raises(ValueError, match="holds no frame"):
        fs.mel_spectrogram_fused(torch.zeros(2, 100), center=None)
