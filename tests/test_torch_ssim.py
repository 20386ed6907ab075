"""The port's SSIM (``xva_trainer_tpu_torch/ops/ssim.py``) against the JAX
package's, per item and averaged, within 1e-5; and the identity and
ordering properties of ``tests/test_misc_parity.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xva_trainer_tpu.ops.ssim import ssim as jax_ssim
from xva_trainer_tpu_torch.ops.ssim import ssim


@pytest.mark.parametrize("shape,window", [((2, 1, 32, 48), 11), ((3, 2, 24, 36), 11),
                                          ((1, 3, 20, 17), 7)])
def test_ssim_matches_jax(shape, window):
    rng = np.random.default_rng(0)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    per = ssim(ta, tb, window, size_average=False)
    assert per.shape == (shape[0],)
    assert np.abs(per.numpy() - np.asarray(jax_ssim(ja, jb, window, size_average=False))).max() < 1e-5
    assert abs(float(ssim(ta, tb, window)) - float(jax_ssim(ja, jb, window))) < 1e-5


def test_ssim_identity_and_ordering():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((2, 1, 32, 48), np.float32))
    assert abs(float(ssim(a, a)) - 1.0) < 1e-4
    b = a + 0.1 * torch.from_numpy(rng.random((2, 1, 32, 48), np.float32))
    c = a + 0.5 * torch.from_numpy(rng.random((2, 1, 32, 48), np.float32))
    assert float(ssim(a, b)) > float(ssim(a, c))
    assert ssim(a, b, size_average=False).shape == (2,)
