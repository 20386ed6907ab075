"""Rule tables of the v2 HiFi-GAN checkpoints: the standalone generator
(``g_`` checkpoints, ``.hg.pt`` exports) and the discriminators (``do_``).

The port's copy of ``xva_trainer_tpu/interop/hifigan_map.py`` (reference
python/hifigan/models.py Generator:81-138, DiscriminatorP:140-177,
DiscriminatorS:205-229, MSD:231-261, with config_v1.json, no conditioning).
``g_`` files hold {'generator': sd}; ``do_`` files hold {'mpd': sd, 'msd':
sd, 'steps', 'epoch', ...} (reference hifigan/xva_train.py:285-296).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .mapping import Rule
from .xvapitch_map import hifigan_decoder_rules, period_disc_rules, scale_disc_rules

# MSD disc 0's spectral-normed convs: convs.0-6, then conv_post
SPECTRAL_CONVS = tuple(f"convs.{i}" for i in range(7)) + ("conv_post",)


def v2_generator_rules(tp: str = "", fp: Tuple[str, ...] = (), num_ups: int = 4,
                       num_kernels: int = 3, num_dilations: int = 3) -> List[Rule]:
    """The standalone v2 generator: weight-normed ``conv_pre`` and
    ``conv_post`` with bias, no cond layer."""
    return hifigan_decoder_rules(tp=tp, fp=fp, num_ups=num_ups, num_kernels=num_kernels,
                                 num_dilations=num_dilations, cond=False,
                                 pre_post_weight_norm=True, post_bias=True)


def v2_mpd_rules(tp: str = "mpd", fp: Tuple[str, ...] = ("MultiPeriodDiscriminator_0",),
                 num_periods: int = 5) -> List[Rule]:
    """The period discriminators, ``{tp}.discriminators.{j}``."""
    rules: List[Rule] = []
    for j in range(num_periods):
        rules += period_disc_rules(f"{tp}.discriminators.{j}", fp + (f"DiscriminatorP_{j}",))
    return rules


def v2_msd_wn_rules(tp: str = "msd", fp: Tuple[str, ...] = ("MultiScaleDiscriminator_0",),
                    num_scales: int = 3) -> List[Rule]:
    """The weight-normed scale discriminators 1 and 2. Disc 0 is
    spectral-normed: ``import_msd_spectral``."""
    rules: List[Rule] = []
    for j in range(1, num_scales):
        rules += scale_disc_rules(f"{tp}.discriminators.{j}", fp + (f"DiscriminatorS_{j}",), 7)
    return rules


def import_msd_spectral(sd: Dict[str, np.ndarray],
                        tp: str = "msd.discriminators.0") -> Dict[str, np.ndarray]:
    """The spectral-normed MSD disc 0 of a reference state dict → the
    entries of the port's ``DiscriminatorS(use_spectral_norm=True)`` under
    ``tp``: ``weight_orig``, ``bias`` and ``weight_u`` from the file, as the
    JAX package imports its kernel and ``u``, and ``weight_v`` from the file
    or, when the file has none, one power-iteration half-step from u
    (normalize(Wᵀu)), as JAX computes it. The forward never reads
    ``weight_v``. (JAX also stores a sigma from the file's u and v, which
    flax never reads: each call iterates once more from u.)"""
    out: Dict[str, np.ndarray] = {}
    for name in SPECTRAL_CONVS:
        key = f"{tp}.{name}"
        w = np.asarray(sd[f"{key}.weight_orig"], np.float32)
        u = np.asarray(sd[f"{key}.weight_u"], np.float32)
        if f"{key}.weight_v" in sd:
            v = np.asarray(sd[f"{key}.weight_v"], np.float32)
        else:
            v = w.reshape(w.shape[0], -1).T @ u
            v /= max(np.linalg.norm(v), 1e-12)
        out[f"{key}.weight_orig"] = w
        out[f"{key}.bias"] = np.asarray(sd[f"{key}.bias"], np.float32)
        out[f"{key}.weight_u"] = u
        out[f"{key}.weight_v"] = v.astype(np.float32)
    return out
