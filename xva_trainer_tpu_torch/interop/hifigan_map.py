"""Rule table of the standalone v2 HiFi-GAN generator (``g_`` checkpoints,
``.hg.pt`` exports).

The port's copy of ``v2_generator_rules`` of
``xva_trainer_tpu/interop/hifigan_map.py`` (reference
python/hifigan/models.py Generator:81-138 with config_v1.json, no
conditioning). The period and scale discriminators' rules come with the
HiFi-GAN trainer.
"""
from __future__ import annotations

from typing import List, Tuple

from .mapping import Rule
from .xvapitch_map import hifigan_decoder_rules


def v2_generator_rules(tp: str = "", fp: Tuple[str, ...] = (), num_ups: int = 4,
                       num_kernels: int = 3, num_dilations: int = 3) -> List[Rule]:
    """The standalone v2 generator: weight-normed ``conv_pre`` and
    ``conv_post`` with bias, no cond layer."""
    return hifigan_decoder_rules(tp=tp, fp=fp, num_ups=num_ups, num_kernels=num_kernels,
                                 num_dilations=num_dilations, cond=False,
                                 pre_post_weight_norm=True, post_bias=True)
