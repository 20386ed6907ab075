"""HiFi-GAN in PyTorch: the MRF generator (speaker-conditioned), the period
and scale discriminators, and the LSGAN and feature-matching losses.

Counterpart of ``xva_trainer_tpu/models/hifigan/models.py`` (reference
python/hifigan/models.py Generator:81-138, ResBlock1:17-55,
DiscriminatorP:141-177, DiscriminatorS:207-240, losses:276-331, and the
xVAPitch decoder python/xvapitch/hifigan.py:160-263), channels-first, with
the reference parameter names. Upsampling is ``ConvTranspose1d`` with
padding (k-u)//2, which equals flax's ``"SAME"`` transpose conv with a
spatially flipped kernel (the weight transfer flips it).

Weight norm normalises every conv over its output axis, as flax's
``nn.WeightNorm`` does: dim 0 of a Conv1d/Conv2d weight (out, in, ...) and
dim 1 of the upsampling ConvTranspose1d weight (in, out, k). The reference
PyTorch trainer normalises the upsampling convs per input channel (dim 0);
the forward pass is the same either way, but training moves (g, v)
differently, and the port follows the JAX package. A reference state dict
converts with ``interop.convert.ups_from_reference``. Every weight-norm scale
starts at 1, as flax's does, so each filter starts with unit norm; the
reference's torch modules keep the norm of their initial weights instead.

The v2 discriminator (``HifiganDiscriminator``: the period discriminators,
then the scale discriminators, the first of them spectral-normed) follows
the JAX package's ``HifiganDiscriminator``; its spectral norm is flax's
``nn.SpectralNorm`` (``SpectralNormConv1d``), not torch's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..conv import same_conv1d, weight_norm

LRELU_SLOPE = 0.1


def _init_wn_conv(in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1) -> nn.Module:
    """Weight-normed 'same' conv whose direction is drawn from N(0, 0.01)."""
    conv = same_conv1d(in_ch, out_ch, kernel_size, dilation=dilation)
    nn.init.normal_(conv.weight, 0.0, 0.01)
    return weight_norm(conv)


@dataclasses.dataclass(frozen=True)
class HifiganConfig:
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    in_channels: int = 80
    cond_channels: int = 0  # 512 for speaker-conditioned variants
    # xVAPitch decoder variant (reference python/xvapitch/model.py:134-149):
    conv_pre_weight_norm: bool = True
    conv_post_weight_norm: bool = True
    conv_post_bias: bool = True

    @property
    def hop(self) -> int:
        h = 1
        for u in self.upsample_rates:
            h *= u
        return h


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, lrelu → dilated conv → lrelu → conv,
    plus the skip."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            _init_wn_conv(channels, channels, kernel_size, d) for d in dilations)
        self.convs2 = nn.ModuleList(
            _init_wn_conv(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """Light MRF block: per dilation, lrelu → dilated conv, plus the skip."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            _init_wn_conv(channels, channels, kernel_size, d) for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """latent/mel (B, C, T) → waveform (B, 1, T*hop) in [-1, 1]."""

    def __init__(self, cfg: HifiganConfig = HifiganConfig()):
        super().__init__()
        c = self.cfg = cfg
        ch0 = c.upsample_initial_channel
        conv_pre = same_conv1d(c.in_channels, ch0, 7)
        self.conv_pre = weight_norm(conv_pre) if c.conv_pre_weight_norm else conv_pre
        if c.cond_channels:
            self.cond_layer = nn.Conv1d(c.cond_channels, ch0, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            up = nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2)
            nn.init.normal_(up.weight, 0.0, 0.01)
            self.ups.append(weight_norm(up, dim=1))  # per output channel, as flax
            for kr, dr in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, kr, tuple(dr)))
        conv_post = same_conv1d(ch0 // (2 ** len(c.upsample_rates)), 1, 7,
                                bias=c.conv_post_bias)
        nn.init.normal_(conv_post.weight, 0.0, 0.01)
        self.conv_post = weight_norm(conv_post) if c.conv_post_weight_norm else conv_post

    def forward(self, x, g=None):
        c = self.cfg
        x = self.conv_pre(x)
        if c.cond_channels:
            x = x + self.cond_layer(g.unsqueeze(-1) if g.dim() == 2 else g)
        n_k = len(c.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = self.resblocks[i * n_k](x)
            for j in range(1, n_k):
                xs = xs + self.resblocks[i * n_k + j](x)
            x = xs / n_k
        x = self.conv_post(F.leaky_relu(x))  # default slope 0.01 here (reference)
        return torch.tanh(x)


class DiscriminatorP(nn.Module):
    """Period discriminator: (B, 1, T) audio reflect-padded to a multiple of
    the period and folded to (B, 1, T/p, p), then (k, 1) convs with the
    symmetric (k-1)//2 padding of torch (not flax's "SAME")."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = ((kernel_size - 1) // 2, 0)
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [weight_norm(nn.Conv2d(a, b, (kernel_size, 1), (stride, 1), padding=pad))
             for a, b in zip(chans[:-1], chans[1:])]
            + [weight_norm(nn.Conv2d(1024, 1024, (kernel_size, 1), 1, padding=pad))])
        self.conv_post = weight_norm(nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0)))

    def forward(self, x):
        B, C, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
            T = x.shape[-1]
        x = x.view(B, C, T // p, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


# v2 MSD scale discriminator (reference python/hifigan/models.py:207-216):
# (channels, kernel, stride, groups, padding)
V2_SCALE_SPECS = (
    (128, 15, 1, 1, 7),
    (128, 41, 2, 4, 20),
    (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20),
    (1024, 41, 4, 16, 20),
    (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)

# v3 (xVAPitch) scale discriminator (reference python/xvapitch/model.py:1560-1568)
V3_SCALE_SPECS = (
    (16, 15, 1, 1, 7),
    (64, 41, 4, 4, 20),
    (256, 41, 4, 16, 20),
    (1024, 41, 4, 64, 20),
    (1024, 41, 4, 256, 20),
    (1024, 5, 1, 1, 2),
)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``_l2_normalize``: x / sqrt(Σx² + eps)."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv1d(nn.Module):
    """A Conv1d whose weight is spectral-normed as flax's ``nn.SpectralNorm``
    (n_steps 1, eps 1e-12) computes it, which ``torch.nn.utils.spectral_norm``
    does not:

    - every call runs one power iteration from the stored ``weight_u``,
      whatever ``update_stats`` says: v = normalize(Wᵀu), u' = normalize(Wv),
      sigma = u'ᵀWv, with u' and v held constant for the gradient, which
      flows through W; the conv uses W / sigma (W where sigma is 0); the
      bias is not normalised;
    - ``update_stats=True`` stores u' (and v); ``update_stats=False`` stores
      nothing. (torch's module skips the iteration in eval mode and always
      stores u in train mode.)

    W is the weight (out, in/groups, k) as an (out, in/groups·k) matrix.
    flax's kernel (k, in/groups, out) reshaped to (k·in/groups, out) is its
    transpose up to the order of the second axis, which sigma does not
    depend on, so flax's ``u`` (1, out) is ``weight_u`` as it is. The
    parameter and buffers keep the reference's names (``weight_orig``,
    ``weight_u``, ``weight_v``), so a reference ``do_`` file loads strictly;
    the forward never reads ``weight_v``. The iteration runs in fp32 outside
    autocast."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: int = 0, eps: float = 1e-12):
        super().__init__()
        conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride, groups=groups, padding=padding)
        self.stride, self.padding, self.groups, self.eps = stride, padding, groups, eps
        self.weight_orig = nn.Parameter(conv.weight.detach())
        self.bias = nn.Parameter(conv.bias.detach())
        k_dim = conv.weight[0].numel()
        self.register_buffer("weight_u", _l2_normalize(torch.randn(out_ch), eps))
        self.register_buffer("weight_v", _l2_normalize(torch.randn(k_dim), eps))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        w = self.weight_orig
        with torch.autocast(w.device.type, enabled=False):
            wm = w.float().reshape(w.shape[0], -1)
            with torch.no_grad():
                v = _l2_normalize(self.weight_u.float() @ wm, self.eps)
                u = _l2_normalize(wm @ v, self.eps)
            sigma = torch.dot(wm @ v, u)
            if update_stats:
                with torch.no_grad():
                    self.weight_u.copy_(u)
                    self.weight_v.copy_(v)
            return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return F.conv1d(x, self.normalized_weight(update_stats), self.bias, self.stride,
                        self.padding, 1, self.groups)


class DiscriminatorS(nn.Module):
    """Scale discriminator on raw (B, 1, T) audio: grouped strided convs with
    explicit padding from ``specs``, weight-normed, or spectral-normed when
    ``use_spectral_norm`` (the v2 MSD's first scale). ``update_sn_stats``
    lets the spectral norm store its power iteration's vectors."""

    def __init__(self, use_spectral_norm: bool = False, specs: tuple = V2_SCALE_SPECS):
        super().__init__()

        def conv(cin, ch, k, s, g, p):
            if use_spectral_norm:
                return SpectralNormConv1d(cin, ch, k, s, groups=g, padding=p)
            return weight_norm(nn.Conv1d(cin, ch, k, s, groups=g, padding=p))

        convs, cin = [], 1
        for ch, k, s, g, p in specs:
            convs.append(conv(cin, ch, k, s, g, p))
            cin = ch
        self.use_spectral_norm = use_spectral_norm
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(cin, 1, 3, 1, 1, 1)

    def _conv(self, conv, x, update_sn_stats: bool):
        return conv(x, update_sn_stats) if self.use_spectral_norm else conv(x)

    def forward(self, x, update_sn_stats: bool = False):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(self._conv(conv, x, update_sn_stats), LRELU_SLOPE)
            fmap.append(x)
        x = self._conv(self.conv_post, x, update_sn_stats)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


def _avg_pool() -> nn.AvgPool1d:
    """flax's ``nn.avg_pool(window 4, stride 2, padding 2)``, which counts
    the padded zeros in each mean, as ``AvgPool1d``'s default does."""
    return nn.AvgPool1d(4, 2, padding=2)


class MultiPeriodDiscriminator(nn.Module):
    """One ``DiscriminatorP`` a period, each called on the real audio, then
    on the generated audio."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y, y_hat):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discriminators:
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


class MultiScaleDiscriminator(nn.Module):
    """``n_scales`` v2 scale discriminators, the first spectral-normed, each
    later one on the audio average-pooled once more. Each is called on the
    real audio, then on the generated audio, so with ``update_sn_stats``
    the spectral norm iterates twice a call, the generated pass from the
    ``u`` the real pass stored."""

    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0)) for i in range(n_scales))
        self.meanpools = nn.ModuleList(_avg_pool() for _ in range(n_scales - 1))

    def forward(self, y, y_hat, update_sn_stats: bool = False):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i != 0:
                y = self.meanpools[i - 1](y)
                y_hat = self.meanpools[i - 1](y_hat)
            o_r, f_r = d(y, update_sn_stats)
            o_g, f_g = d(y_hat, update_sn_stats)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


class HifiganDiscriminator(nn.Module):
    """The v2 discriminator, MPD (``mpd``) and MSD (``msd``) as one module
    (one parameter list, one optimiser); the reference's ``do_`` file holds
    the two state dicts under these names. ``forward(y, y_hat,
    update_sn_stats=False)`` on (B, 1, T) real and generated audio →
    (outs_r, outs_g, fmaps_r, fmaps_g), the MPD's entries first. Reduced
    ``periods`` and ``n_scales`` serve the tests."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11), n_scales: int = 3):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods)
        self.msd = MultiScaleDiscriminator(n_scales)

    def forward(self, y, y_hat, update_sn_stats: bool = False):
        p = self.mpd(y, y_hat)
        s = self.msd(y, y_hat, update_sn_stats)
        return tuple(a + b for a, b in zip(p, s))


# ---------------- losses (reference models.py:276-331) ----------------


def feature_matching_loss(fmaps_r, fmaps_g):
    """Σ mean|real_fmap - fake_fmap| × 2, with no gradient on the real side."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r.detach().float() - g.float()))
    return loss * 2.0


def discriminator_loss(outs_real, outs_fake):
    """LSGAN: Σ mean((1-D(y))²) + mean(D(ŷ)²)."""
    loss = 0.0
    for dr, dg in zip(outs_real, outs_fake):
        loss = loss + torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
    return loss


def generator_adv_loss(outs_fake):
    """LSGAN: Σ mean((1-D(ŷ))²)."""
    loss = 0.0
    for dg in outs_fake:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss
