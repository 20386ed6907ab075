"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); skips elsewhere. Run on the card
(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from xva_trainer_tpu_torch.ops import _cuda
from xva_trainer_tpu_torch.ops import fused_stft as fs
from xva_trainer_tpu_torch.ops.stft import MelConfig

pytestmark = pytest.mark.cuda
TOL = 1e-3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bucket(device, B=4, T=65536 + 1024, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050.0
    y = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal((B, T))
    return torch.from_numpy(y.astype(np.float32)).to(device)


def _held(y, cfg=MelConfig(), **kw):
    """The kernel's (mel, linear) and the plain version's, after checking that
    they agree at mean and max abs < TOL."""
    out = fs.mel_spectrogram_fused(y, cfg, return_linear=True, **kw)
    ref = fs.mel_spectrogram_fused_reference(y, cfg, return_linear=True, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.is_cuda and bool(torch.isfinite(o).all())
        d = (o - r).abs()
        assert d.mean().item() < TOL and d.max().item() < TOL
    return out, ref


@pytest.mark.parametrize("center,mag_eps", [(None, 0.0), (True, 0.0), (False, 1e-9)])
@pytest.mark.parametrize("return_linear", [True, False])
def test_kernel_matches_plain(cuda, center, mag_eps, return_linear):
    y = _bucket(cuda)
    kw = dict(center=center, mag_eps=mag_eps, return_linear=return_linear)
    before = _cuda.LAUNCHES["fused_stft"]
    out = fs.mel_spectrogram_fused(y, **kw)
    ref = fs.mel_spectrogram_fused_reference(y, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_stft"] == before + 1
    pairs = zip(out, ref) if return_linear else [(out, ref)]
    for o, r in pairs:
        assert o.shape == r.shape and o.is_cuda
        d = (o - r).abs()
        assert d.mean().item() < TOL and d.max().item() < TOL


def test_kernel_nyquist_bin(cuda):
    """An alternating +-0.5 signal puts its energy in bin 512, which the
    kernel takes from Z[0] of its FFT."""
    y = torch.from_numpy(0.5 * (-1.0) ** np.arange(16384)).float().to(cuda).repeat(2, 1)
    (mel, lin), (_, rlin) = _held(y)
    assert (lin[:, 512] - rlin[:, 512]).abs().max().item() < TOL
    assert rlin[:, 512, 4:-4].min().item() > 100  # the energy is where it should be


def test_kernel_silence(cuda):
    (mel, lin), _ = _held(torch.zeros((2, 8192), device=cuda))
    assert (mel - math.log(1e-5)).abs().max().item() < 1e-5
    assert lin.abs().max().item() == 0.0


def test_kernel_full_scale_chirp(cuda):
    t = np.arange(3 * 22050) / 22050.0
    y = np.sign(np.sin(2 * np.pi * (50 * t + 1800 * t * t)))  # +-1, 50 Hz to 10.8 kHz
    _held(torch.from_numpy(y).float().to(cuda)[None].repeat(3, 1))


def test_kernel_win_length_800(cuda):
    _held(_bucket(cuda, B=2, T=30000), MelConfig(win_length=800))


@pytest.mark.parametrize("batch", [1, 3])
def test_kernel_one_frame(cuda, batch):
    (mel, lin), _ = _held(_bucket(cuda, B=batch, T=1024), center=None)
    assert mel.shape == (batch, 80, 1) and lin.shape == (batch, 513, 1)


@pytest.mark.parametrize("shape,center", [((22051,), True), ((3, 22051), None),
                                          ((3, 22051), True)])
def test_kernel_odd_length_rows(cuda, shape, center):
    """Rows of odd length start at every alignment, so the staged spans
    start unaligned."""
    y = _bucket(cuda, B=3, T=22051)
    _held(y[0] if len(shape) == 1 else y, center=center)


@pytest.mark.parametrize("hop", [1024, 1500])
def test_kernel_long_hop(cuda, hop):
    """hop = 1024: frames abut; hop > 1024: each frame is staged on its own."""
    _held(_bucket(cuda, B=2, T=40000), MelConfig(hop_length=hop))


@pytest.mark.parametrize("hop", [128, 200, 256])
def test_kernel_any_hop_and_1d(cuda, hop):
    cfg = MelConfig(hop_length=hop)
    y = _bucket(cuda, B=1, T=30000)[0]
    mel, lin = fs.mel_spectrogram_fused(y, cfg, return_linear=True)
    rmel, rlin = fs.mel_spectrogram_fused_reference(y, cfg, return_linear=True)
    torch.cuda.synchronize()
    assert mel.dim() == 2 and mel.shape == rmel.shape
    assert (mel - rmel).abs().mean().item() < TOL
    assert (lin - rlin).abs().mean().item() < TOL


def test_kernel_rejects_other_n_fft(cuda):
    y = _bucket(cuda, B=1, T=8192)
    with pytest.raises(ValueError, match="n_fft"):
        fs.mel_spectrogram_fused(y, MelConfig(n_fft=512, win_length=512, hop_length=128))
