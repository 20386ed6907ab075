"""Learned speech enhancement for the 'ass' tool: a complex-ratio-mask
denoiser (the role of the reference's pretrained asteroid DCCRNet).

Counterpart of ``xva_trainer_tpu/models/enhance/model.py``: a UNet of real
convolutions over the stacked (re, im) spectrogram predicts a bounded
complex ratio mask; STFT → mask → iSTFT. It trains with negative SI-SDR on
(noisy, clean) pairs.

Three places where the layers are flax's, not torch's defaults:
- ``LayerNorm`` takes flax's epsilon, 1e-6, over the channels only;
- the GELU is the tanh approximation (flax's ``nn.gelu`` default);
- the convolutions pad as lax's "SAME" does (``_same``), and a transposed
  convolution is ``F.conv_transpose2d`` with padding (1, 1) and its last
  frequency column dropped, its kernel carried flipped on both spatial axes
  (``interop/mapping.py`` kind ``convT2d``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device
from ...ops.griffin_lim import istft
from ...ops.stft import MelConfig, device_constant, frame_signal, hann_window


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    n_fft: int = 512
    hop: int = 128
    base_channels: int = 24
    depth: int = 4
    sample_rate: int = 22050

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def _stft(y: torch.Tensor, cfg: EnhanceConfig) -> torch.Tensor:
    """(..., T) → complex (..., F, frames), centered: a reflect pad of
    n_fft/2, a zero pad to whole hops, a periodic Hann window."""
    num_frames = 1 + y.shape[-1] // cfg.hop
    pad = cfg.n_fft // 2
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    need = (num_frames + cfg.n_fft // cfg.hop) * cfg.hop
    if y.shape[-1] < need:
        y = F.pad(y, (0, need - y.shape[-1]))
    frames = frame_signal(y, cfg.n_fft, cfg.hop, num_frames)
    win = device_constant(hann_window, (cfg.n_fft, cfg.n_fft), y.device)
    return torch.fft.rfft(frames * win, dim=-1).transpose(-1, -2)


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax's "SAME" padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    (kt, kf), (st, sf) = conv.kernel_size, conv.stride
    t, f = _same(x.shape[2], kt, st), _same(x.shape[3], kf, sf)
    return conv(F.pad(x, (*f, *t)))


def _channel_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of (B, C, T, F)."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class ComplexMaskNet(nn.Module):
    """(B, T, F, 2) re/im → bounded complex ratio mask (B, T, F, 2).

    Modules in flax's call order: ``enc[d]`` and ``enc_norm[d]`` are
    ``Conv_{2d}`` and ``LayerNorm_{d}``, ``down[d]`` is ``Conv_{2d+1}``;
    ``up[i]`` and ``dec_norm[i]`` are ``ConvTranspose_{i}`` and
    ``LayerNorm_{depth+i}`` (depth ``depth-1-i``); ``out`` is
    ``Conv_{2 depth}``."""

    def __init__(self, cfg: EnhanceConfig = EnhanceConfig()):
        super().__init__()
        self.cfg = cfg
        widths = [cfg.base_channels * 2 ** d for d in range(cfg.depth)]
        ins = [2] + widths[:-1]
        self.enc = nn.ModuleList(nn.Conv2d(i, w, (3, 5)) for i, w in zip(ins, widths))
        self.enc_norm = nn.ModuleList(nn.LayerNorm(w, eps=1e-6) for w in widths)
        self.down = nn.ModuleList(nn.Conv2d(w, w, (3, 5), stride=(1, 2)) for w in widths)
        dec = list(reversed(range(cfg.depth)))
        self.up = nn.ModuleList(
            nn.ConvTranspose2d(widths[min(d + 1, cfg.depth - 1)], widths[d], (3, 5),
                               stride=(1, 2), padding=(1, 1)) for d in dec)
        self.dec_norm = nn.ModuleList(nn.LayerNorm(widths[d], eps=1e-6) for d in dec)
        self.out = nn.Conv2d(cfg.base_channels, 2, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)  # (B, 2, T, F)
        skips = []
        for enc, norm, down in zip(self.enc, self.enc_norm, self.down):
            h = _gelu(_channel_norm(norm, _conv_same(enc, h)))
            skips.append(h)
            h = _gelu(_conv_same(down, h))
        for up, norm, s in zip(self.up, self.dec_norm, reversed(skips)):
            h = up(h)[..., :-1]  # lax's SAME transposed conv: 2 F columns per input
            h = h[:, :, : s.shape[2], : s.shape[3]]
            if h.shape[3] < s.shape[3]:
                h = F.pad(h, (0, s.shape[3] - h.shape[3]))
            h = _gelu(_channel_norm(norm, h + s))
        return torch.tanh(_conv_same(self.out, h)).permute(0, 2, 3, 1)


def enhance_spec(model: ComplexMaskNet, y: torch.Tensor) -> torch.Tensor:
    """One (T,) waveform → its enhanced waveform of (frames - 1)·hop
    samples: STFT → the mask applied as a complex product → iSTFT."""
    cfg = model.cfg
    spec = _stft(y, cfg)  # (F, frames)
    x = torch.stack([spec.real, spec.imag], dim=-1).transpose(0, 1)  # (frames, F, 2)
    mask = model(x[None])[0]
    mr, mi = mask[..., 0].T, mask[..., 1].T
    out = torch.complex(spec.real * mr - spec.imag * mi, spec.real * mi + spec.imag * mr)
    return istft(out, MelConfig(n_fft=cfg.n_fft, hop_length=cfg.hop, win_length=cfg.n_fft))


class SpeechEnhancer:
    """Host-facing wrapper: enhance a waveform chunk by chunk on ``device``.

    The weights are ``state_dict`` when given (loaded strictly), else the
    module's own initialisation under ``torch.manual_seed(seed)``."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 cfg: EnhanceConfig = EnhanceConfig(), seed: int = 0,
                 chunk_seconds: float = 4.0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = ComplexMaskNet(cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.chunk = int(chunk_seconds * cfg.sample_rate)
        self.chunk -= self.chunk % cfg.hop

    @torch.no_grad()
    def _enhance(self, seg: np.ndarray) -> np.ndarray:
        y = torch.from_numpy(np.ascontiguousarray(seg, np.float32)).to(self.device)
        return enhance_spec(self.model, y).cpu().numpy()

    def enhance(self, y: np.ndarray) -> np.ndarray:
        """Chunked enhancement with a linear crossfade of ``ov`` samples at
        each seam (the mask and each chunk's STFT edges change there), no
        fade at the ends, float64 accumulators."""
        n = self.chunk
        ov = min(4096, n // 4)
        hopn = n - ov
        total = max(len(y), 1)
        acc = np.zeros(total + n, np.float64)
        wsum = np.zeros(total + n, np.float64)
        ramp = np.linspace(0.0, 1.0, ov, endpoint=False)
        win = np.ones(n)
        win[:ov] = ramp
        win[-ov:] = ramp[::-1]
        s = 0
        while s < total:
            seg = y[s:s + n]
            orig = len(seg)
            if orig < n:
                seg = np.pad(seg, (0, n - orig))
            out = self._enhance(seg)
            w = win.copy()
            if s == 0:
                w[:ov] = 1.0
            if s + n >= total:
                w[-ov:] = 1.0
            acc[s:s + n] += out * w
            wsum[s:s + n] += w
            s += hopn
        return (acc[: len(y)] / np.maximum(wsum[: len(y)], 1e-8)).astype(np.float32)


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """Weights saved by the JAX package's ``scripts/train_default_enhancer.py``
    (flat ``params/<Module>_<i>/<leaf>`` keys, fp16) → the fp32 state dict of
    ``ComplexMaskNet`` (``interop/convert.py::enhancer_state_dict``)."""
    from ...interop.convert import enhancer_state_dict

    tree: Dict = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[k].astype(np.float32)
    return enhancer_state_dict(tree)


def si_sdr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis (higher is better)."""
    ref = ref - ref.mean(dim=-1, keepdim=True)
    est = est - est.mean(dim=-1, keepdim=True)
    proj = (torch.sum(est * ref, -1, keepdim=True)
            / (torch.sum(ref * ref, -1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = (torch.sum(proj ** 2, -1) + eps) / (torch.sum(noise ** 2, -1) + eps)
    return 10.0 * torch.log10(ratio)


def train_enhancer(
    noisy: np.ndarray,
    clean: np.ndarray,
    cfg: EnhanceConfig = EnhanceConfig(),
    steps: int = 200,
    lr: float = 3e-4,
    seed: int = 0,
    batch: int = 4,
    segment: int = 32768,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    device="cuda",
):
    """Fit the denoiser on aligned (noisy, clean) waveform pairs with
    negative SI-SDR through STFT → mask → iSTFT, from ``state_dict`` (else
    ``SpeechEnhancer``'s seed-0 initialisation). AdamW as optax's
    ``adamw(lr)``: weight decay 1e-4, eps 1e-8. Segments are drawn from
    ``np.random.default_rng(seed)``. Returns (trained state dict, losses)."""
    enh = SpeechEnhancer(state_dict, cfg, device=device)
    model = enh.model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    segment -= segment % cfg.hop
    losses = []
    for _ in range(steps):
        starts = rng.integers(0, max(1, len(noisy) - segment), batch)
        ny = torch.from_numpy(np.stack([noisy[s:s + segment] for s in starts])).to(enh.device)
        cy = torch.from_numpy(np.stack([clean[s:s + segment] for s in starts])).to(enh.device)
        est = torch.stack([enhance_spec(model, y) for y in ny])
        L = min(est.shape[-1], cy.shape[-1])
        loss = -torch.mean(si_sdr(est[..., :L], cy[..., :L]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    model.eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, losses
