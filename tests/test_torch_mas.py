"""Port parity of monotonic alignment search: the plain version (what a CPU
tensor runs; the CUDA kernel is held to it on the card by
tests/test_torch_kernels_cuda.py) against the JAX package's
``maximum_path``, on every case of tests/test_mas.py and the bf16 case of
tests/test_amp.py. The DP adds and compares the same fp32 values in the same
order on both sides, so the paths must be equal, not close."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_mas import _oracle

from xva_trainer_tpu.ops.mas import maximum_path as jax_maximum_path
from xva_trainer_tpu_torch.ops import mas


def _case(seed, B, tx, ty, lens=None, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B, tx, ty)) * scale + shift).astype(np.float32)
    mask = np.zeros((B, tx, ty), np.float32)
    for b, (x, y) in enumerate(lens or [(tx, ty)] * B):
        mask[b, :x, :y] = 1
    return value, mask


CASES = {
    "square": (0, 3, 16, 16, [(16, 16), (10, 14), (5, 16)]),
    "rect": (1, 4, 24, 96, [(24, 96), (7, 60), (20, 21), (1, 40)]),
    "oracle": (2, 2, 12, 40, None),
    "one_token": (3, 2, 1, 30, [(1, 30), (1, 7)]),
    "more_tokens_than_frames": (4, 3, 30, 12, [(30, 12), (20, 5), (12, 12)]),
}


def _both(value, mask, dtype=None):
    jv, jm = jnp.asarray(value), jnp.asarray(mask)
    tv, tm = torch.from_numpy(value), torch.from_numpy(mask)
    if dtype is not None:
        jv, jm = jv.astype(jnp.bfloat16), jm.astype(jnp.bfloat16)
        tv, tm = tv.to(dtype), tm.to(dtype)
    ref = jax_maximum_path(jv, jm)
    ours = mas.maximum_path(tv, tm)
    return np.asarray(ref.astype(jnp.float32)), ours, str(ref.dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_path_equals_jax(name):
    value, mask = _case(*CASES[name])
    ref, ours, _ = _both(value, mask)
    assert ours.dtype == torch.float32 and np.array_equal(ours.numpy(), ref)
    if name == "oracle":  # and the plain-loop oracle of tests/test_mas.py
        for b in range(value.shape[0]):
            assert np.array_equal(ours[b].numpy(), _oracle(value[b], 12, 40))


def test_extreme_magnitudes_equal_jax():
    """Cumulative scores far below any finite sentinel (3e6·N(0,1) - 2e6
    over 900 frames): true -inf keeps the path valid, and equal to JAX's."""
    value, mask = _case(0, 2, 12, 900, scale=3e6, shift=-2e6)
    ref, ours, _ = _both(value, mask)
    assert np.array_equal(ours.numpy(), ref)
    assert (ours.sum(dim=1) == 1).all()


def test_bf16_accumulates_fp32():
    """The bf16 case of tests/test_amp.py: a bf16 path, equal to JAX's and to
    the fp32 path of the same values."""
    rng = np.random.default_rng(0)
    value = rng.standard_normal((2, 12, 40)).astype(np.float32)
    mask = np.ones((2, 12, 40), np.float32)
    mask[0, 9:, :] = 0
    mask[0, :, 30:] = 0
    ref, ours, ref_dtype = _both(value, mask, torch.bfloat16)
    assert ref_dtype == "bfloat16" and ours.dtype == torch.bfloat16
    assert np.array_equal(ours.float().numpy(), ref)
    # bf16-rounded values, accumulated fp32: the fp32 path of those values
    rounded = torch.from_numpy(value).bfloat16().float()
    assert torch.equal(ours.float(), mas.maximum_path(rounded, torch.from_numpy(mask)))


def test_mask_lengths_and_refusals():
    value, mask = _case(*CASES["rect"])
    x_len, y_len = mas.mask_lengths(torch.from_numpy(mask))
    assert x_len.tolist() == [24, 7, 20, 1] and y_len.tolist() == [96, 60, 21, 40]
    # an item with an empty mask still counts one position and one frame
    x_len, y_len = mas.mask_lengths(torch.zeros((1, 5, 6)))
    assert x_len.tolist() == [1] and y_len.tolist() == [1]
    with pytest.raises(ValueError, match="shape"):
        mas.maximum_path(torch.zeros((2, 3, 4)), torch.zeros((2, 3, 5)))
    assert mas.shared_bytes(192, 768) == 4 * (2 * 192 + 768 * 6 + 768)


def test_cpu_wrapper_counts_no_launch():
    """A CPU tensor takes the plain version, which is no launch; another
    device has no fallback."""
    from xva_trainer_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    value, mask = _case(*CASES["square"])
    mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert _cuda.LAUNCHES["mas"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        mas.maximum_path(torch.empty((1, 3, 4), device="meta"),
                         torch.empty((1, 3, 4), device="meta"))


def _kernel_emulation(value, mask):
    """csrc/mas.cu's algorithm in numpy, for one batch: the fp32 DP over the
    frames y < y_len, the direction bits packed 32 to a word as
    ``__ballot_sync`` packs them (bit x % 32 of word x // 32), one thread's
    backtrack recording the path's x per frame (-1 for none), and the path
    written row by row as mask[x, y] where x is the frame's."""
    B, tx, ty = value.shape
    words = (tx + 31) // 32
    x_lens, y_lens = (t.tolist() for t in mas.mask_lengths(torch.from_numpy(mask)))
    out = np.zeros_like(value)
    for b in range(B):
        v = np.where(mask[b] > 0, value[b], -np.inf).astype(np.float32)
        q = np.full(tx, -np.inf, np.float32)
        q[0] = v[0, 0]
        dirs = np.zeros((ty, words), np.uint64)
        for y in range(1, y_lens[b]):
            shifted = np.concatenate([[-np.inf], q[:-1]]).astype(np.float32)
            diag = shifted >= q
            for w in range(words):
                bits = diag[32 * w: 32 * w + 32]
                dirs[y, w] = sum(int(bit) << i for i, bit in enumerate(bits))
            q = (v[:, y] + np.maximum(shifted, q)).astype(np.float32)
        xs, x = np.full(ty, -1), 0
        for y in range(ty - 1, -1, -1):
            if y == y_lens[b] - 1:
                x = x_lens[b] - 1
            if y < y_lens[b]:
                xs[y] = x
                if y > 0:
                    xi = x + tx if x < 0 else x
                    x -= (int(dirs[y, xi // 32]) >> (xi % 32)) & 1
        for y in range(ty):
            if xs[y] >= 0:
                out[b, xs[y], y] = mask[b, xs[y], y]
    return out


@pytest.mark.parametrize("name", ["square", "rect", "more_tokens_than_frames"])
def test_kernel_algorithm_emulation(name):
    """The kernel's bit packing and backtrack give the plain version's path
    (tests/test_torch_kernels_cuda.py holds the kernel itself on the card);
    t_x = 40 spans two words."""
    seed, B, tx, ty, lens = CASES[name]
    if name == "square":
        tx, lens = 40, [(40, 16), (33, 14), (5, 16)]
    value, mask = _case(seed, B, tx, ty, lens)
    ref = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    assert np.array_equal(_kernel_emulation(value, mask), ref)
