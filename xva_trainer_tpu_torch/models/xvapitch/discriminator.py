"""VITS discriminator: one scale discriminator and the period discriminators
of periods 2, 3, 5, 7, 11 (reference python/xvapitch/model.py:1590-1631).

Counterpart of ``xva_trainer_tpu/models/xvapitch/discriminator.py``, with the
reference torch names (``nets.0`` the scale discriminator, ``nets.1-5`` the
periods).
"""
from __future__ import annotations

import torch.nn as nn

from ..hifigan.models import V3_SCALE_SPECS, DiscriminatorP, DiscriminatorS


class VitsDiscriminator(nn.Module):
    def __init__(self, periods: tuple = (2, 3, 5, 7, 11), scale_specs: tuple = V3_SCALE_SPECS):
        super().__init__()
        # the v3 scale spec (16→64→256→1024, stride 4; reference
        # python/xvapitch/model.py:1560-1568), not the v2 MSD's
        self.nets = nn.ModuleList([DiscriminatorS(specs=scale_specs)]
                                  + [DiscriminatorP(p) for p in periods])

    def forward(self, x, x_hat=None):
        """x: fake (or sole) waveform (B, 1, T); x_hat: real waveform.
        Returns (x_scores, x_feats, x_hat_scores, x_hat_feats), one entry per
        sub-discriminator (the x_hat lists are None without x_hat)."""
        x_scores, x_feats = [], []
        xh_scores = [] if x_hat is not None else None
        xh_feats = [] if x_hat is not None else None
        for net in self.nets:
            s, f = net(x)
            x_scores.append(s)
            x_feats.append(f)
            if x_hat is not None:
                s2, f2 = net(x_hat)
                xh_scores.append(s2)
                xh_feats.append(f2)
        return x_scores, x_feats, xh_scores, xh_feats
