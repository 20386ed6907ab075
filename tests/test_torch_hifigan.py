"""Port parity: HiFi-GAN MRF residual blocks against the JAX package, with
weights carried across by the port's weight-norm rules (flax's scale and
kernel as weight_g and weight_v). Tolerance: 1e-3 mean L1 (and relative to
the output's scale)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xva_trainer_tpu.models.hifigan.models import ResBlock1 as JaxResBlock1
from xva_trainer_tpu.models.hifigan.models import ResBlock2 as JaxResBlock2
from xva_trainer_tpu_torch.interop.mapping import apply_carry
from xva_trainer_tpu_torch.interop.xvapitch_map import _wn_conv
from xva_trainer_tpu_torch.models.hifigan import ResBlock1, ResBlock2


def _rules(block, n):
    rules = []
    for c in range(n):
        if block == "1":
            rules += _wn_conv(f"convs1.{c}", (), f"Conv_{2 * c}", f"WeightNorm_{2 * c}")
            rules += _wn_conv(f"convs2.{c}", (), f"Conv_{2 * c + 1}", f"WeightNorm_{2 * c + 1}")
        else:
            rules += _wn_conv(f"convs.{c}", (), f"Conv_{c}", f"WeightNorm_{c}")
    return rules


@pytest.mark.parametrize("block,kernel,dilations", [
    ("1", 3, (1, 3, 5)), ("1", 7, (1, 3, 5)), ("2", 3, (1, 3)), ("2", 5, (2, 4))])
def test_resblock_matches_jax(block, kernel, dilations):
    torch.set_num_threads(1)
    C, T = 16, 50
    x = np.random.default_rng(0).standard_normal((2, T, C)).astype(np.float32)
    jcls, tcls = (JaxResBlock1, ResBlock1) if block == "1" else (JaxResBlock2, ResBlock2)
    jm = jcls(C, kernel, dilations)
    # flax's WeightNorm starts its scale at 1: every conv has unit-norm
    # filters, so the residual branch is of the order of the input
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))

    port = tcls(C, kernel, dilations)
    sd = apply_carry(params, _rules(block, len(dilations)))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = port(torch.from_numpy(x.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    err = np.abs(ours - ref).mean()
    assert np.abs(ref - x).mean() > 0.1
    assert err < 1e-3 and err < 1e-4 * np.abs(ref - x).mean()
