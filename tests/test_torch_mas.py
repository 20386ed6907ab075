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


def _start_minus_inf():
    """-inf at (0, 0): the backtrack walks below x = 0 (item 1 from inside
    its lengths, x_len < t_x); on the parent the plain version raised."""
    value, mask = _case(9, 2, 10, 30, [(10, 30), (7, 22)])
    value[:, 0, 0] = -np.inf
    return value, mask


def _minus_inf_column():
    value, mask = _case(10, 2, 10, 30, [(10, 30), (7, 22)])
    value[:, :, 0] = -np.inf
    return value, mask


def _nan_under_mask():
    value, mask = _case(11, 2, 10, 30, [(10, 30), (7, 22)])
    value[0, 3, 7] = value[1, 0, 0] = np.nan
    return value, mask


def _fractional_mask():
    value, mask = _case(12, 2, 10, 30, [(10, 30), (7, 22)])
    return value, mask * np.random.default_rng(12).uniform(0.2, 1.0, mask.shape).astype(
        np.float32)


def _non_rectangular_mask():
    value, mask = _case(13, 2, 10, 30, [(10, 30), (7, 22)])
    mask[0, 4, 9] = mask[1, 2, 3] = 0
    return value, mask


SPECIAL = {"start_minus_inf": _start_minus_inf, "minus_inf_column_at_frame_0": _minus_inf_column,
           "nan_under_mask": _nan_under_mask, "fractional_mask": _fractional_mask,
           "non_rectangular_mask": _non_rectangular_mask}


@pytest.mark.parametrize("name", list(SPECIAL))
def test_special_cases_equal_jax(name):
    """-inf and NaN scores and masks that are not 0/1 outer products: the
    plain version's path equals JAX's, and the kernel's emulation equals it."""
    value, mask = SPECIAL[name]()
    ref, ours, _ = _both(value, mask)
    assert np.array_equal(ours.numpy(), ref)
    if name == "start_minus_inf":  # the walk left the rows: frames without a path entry
        assert (ours.numpy().sum(axis=(1, 2)) < mask[:, 0, :].sum(1)).all()


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
    # the trainer's largest bucket: three stages of 32-frame fp32 tiles of
    # value and mask (rows of 36 elements), one byte a lane a frame, the path's x
    # a frame and two boundary scores
    assert mas.shared_bytes(192, 768) == 3 * 2 * 192 * 36 * 4 + 768 * 32 + 4 * 768 + 16
    assert mas.plan(192, 768) == (32, 3, True, 193552)
    assert mas.plan(256, 896) == (16, 3, True, mas.shared_bytes(256, 896, frames=16))
    assert [mas.chunk(tx) for tx in (1, 64, 96, 128, 192, 256, 300)] == [1, 3, 3, 5, 7, 9, 9]
    assert mas.plan(1100, 1500) == (8, 2, False, mas.shared_bytes(1100, 1500, frames=8,
                                                                   stages=2, dirs_shared=False))
    assert mas.plan(4096, 4096) is None


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
    """csrc/mas.cu's algorithm in numpy, at the layout ``mas.plan`` picks.
    Per item: tiles of F frames staged for rows [0, x_len) only (the rows
    above hold stale garbage, NaN and inf among it, which must not matter);
    lane l of warp w holds rows x = K(32w + l) + k, k < K, takes row x0 - 1
    from lane l - 1 (lane 0 from warp w - 1's lane 31, or -inf), and writes a
    word of K direction bits a frame; one thread backtracks over (lane, k),
    D = min(4, K) frames at a time from two lanes' words while it can, with
    the out-of-range rule (x in [-t_x, -1] at x + t_x, where the rows
    may hold garbage scores: a walk below 0 emits no more; x < -t_x as 1);
    then the path, zeroed, gets mask[x, y] at each active frame's x."""
    B, tx, ty = value.shape
    K = mas.chunk(tx)
    W = -(-tx // (32 * K))
    F = mas.plan(tx, ty).frames
    xg = K * (32 * np.arange(W)[:, None, None] + np.arange(32)[None, :, None]) \
        + np.arange(K)[None, None, :]  # (W, 32, K): each slot's x
    x_lens, y_lens = (t.tolist() for t in mas.mask_lengths(torch.from_numpy(mask)))
    garbage = np.random.default_rng(1).choice(
        np.array([np.nan, np.inf, -np.inf, 3.0, -7.5], np.float32), (tx, F))
    out = np.full_like(value, np.nan)  # torch.empty
    for b in range(B):
        out[b] = 0  # the producers' zero fill
        v = np.where(mask[b] > 0, value[b], -np.inf).astype(np.float32)
        dirs = np.zeros((ty, 32 * W), np.uint16)
        for y0 in range(0, y_lens[b], F):
            staged = garbage.copy()
            n = min(F, y_lens[b] - y0)
            staged[:x_lens[b], :n] = v[:x_lens[b], y0:y0 + n]
            vv = staged[np.minimum(xg, tx - 1)]  # (W, 32, K, F): rows >= t_x read row t_x - 1
            for c in range(n):
                if y0 + c == 0:
                    q = np.where(xg == 0, vv[..., 0], np.float32(-np.inf)).astype(np.float32)
                    continue
                up = np.roll(q[:, :, K - 1], 1, axis=1)  # lane l - 1's last row
                up[:, 0] = np.concatenate([[-np.inf], q[:-1, 31, K - 1]])  # warp w - 1's
                shifted = np.concatenate([up[..., None], q[..., :-1]], axis=-1)
                with np.errstate(invalid="ignore"):  # the garbage rows' NaN and inf
                    bits = (shifted >= q).astype(np.uint16)
                    q = (vv[..., c] + np.maximum(shifted, q)).astype(np.float32)
                dirs[y0 + c] = (bits << np.arange(K, dtype=np.uint16)).sum(-1).reshape(-1)
        xs, y = {}, y_lens[b] - 1
        slot, k = divmod(x_lens[b] - 1, K)
        D = min(4, K)  # frames a step, read from the words of lanes slot and slot - 1
        while K >= 3 and y >= D and slot >= 1:
            u = [(int(dirs[y - j, slot]) << K) | int(dirs[y - j, slot - 1]) for j in range(D)]
            drop = 0
            for j in range(D):
                xs[y - j] = K * slot + k - drop
                drop += (u[j] >> (K + k - drop)) & 1
            k -= drop
            if k < 0:
                k, slot = k + K, slot - 1
            y -= D
        while y > 0 and slot >= 0:
            xs[y] = K * slot + k
            k -= (int(dirs[y, slot]) >> k) & 1
            if k < 0:
                k, slot = K - 1, slot - 1
            y -= 1
        x = K * slot + k
        for y in range(y, -1, -1):
            xs[y] = x
            if y > 0:
                bit = 1
                if x >= -tx:
                    s_, k_ = divmod(x + tx, K)
                    bit = (int(dirs[y, s_]) >> k_) & 1
                x -= bit
        for y, x in xs.items():
            if x >= 0:
                out[b, x, y] = mask[b, x, y]
    return out


EMULATED = {
    "square": (0, 3, 40, 16, [(40, 16), (33, 14), (5, 16)]),  # K = 3
    "rect": CASES["rect"],
    "more_tokens_than_frames": CASES["more_tokens_than_frames"],
    "tx_not_multiple_of_chunk": (5, 3, 151, 50, [(151, 50), (77, 41), (3, 9)]),
    "above_one_warp": (6, 2, 300, 40, [(300, 40), (290, 33)]),
    "y_len_inside_a_tile": (7, 2, 20, 96, [(20, 45), (11, 70)]),
    "ty_not_multiple_of_tile": (8, 2, 24, 75, [(24, 75), (9, 38)]),
}


@pytest.mark.parametrize("name", list(EMULATED) + ["start_minus_inf"])
def test_kernel_algorithm_emulation(name):
    """The redesigned kernel's tiles, lanes, bit bytes, backtrack and path
    write give the plain version's path (tests/test_torch_kernels_cuda.py
    holds the kernel itself on the card)."""
    if name == "start_minus_inf":
        value, mask = SPECIAL["start_minus_inf"]()
    else:
        value, mask = _case(*EMULATED[name])
    ref = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    assert np.array_equal(_kernel_emulation(value, mask), ref)
