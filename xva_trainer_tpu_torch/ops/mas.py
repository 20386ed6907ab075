"""Monotonic alignment search (MAS): the wrapper of the hand-written CUDA
kernel ``csrc/mas.cu`` and its plain version.

Counterpart of ``xva_trainer_tpu/ops/mas.py::maximum_path``, with every one
of its semantics:

- scores are -inf (true -inf, not a finite sentinel) where the mask is 0;
- bf16 input is accumulated in fp32 and the path comes back in the input's
  type;
- the lengths are read from the mask (column 0 and row 0) and clamped to at
  least 1 (and at most t_x, t_y, which a 0/1 mask never reaches);
- at frame 0 only x = 0 is reachable, and ``shifted >= q_prev`` gives ties to
  the diagonal;
- the backtrack starts at (x_len-1, y_len-1), emits nothing on padded frames
  and moves only at frames y > 0; an x below 0 (only -inf scores in row 0
  lead there) reads its bit at x + t_x for x >= -t_x and as a diagonal step
  below that, as ``take_along_axis`` does at xva_trainer_tpu/ops/mas.py:81;
- the path is multiplied by the mask.

The plain version is the same dynamic program in torch, one vectorised step
per frame, and adds and compares the same fp32 values in the same order as
the kernel and the JAX scan: the paths are equal, not close. A CUDA tensor
goes through the kernel or the call raises; a CPU tensor goes through the
plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _cuda

KERNEL = "mas"
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SHARED_BYTES = 232448  # the most a block may use on Hopper


def _prepare(value: torch.Tensor, mask: torch.Tensor):
    if value.dim() != 3 or mask.shape != value.shape:
        raise ValueError(f"expected value and mask of one (B, t_x, t_y) shape, got "
                         f"{tuple(value.shape)} and {tuple(mask.shape)}")
    if value.shape[1] < 1 or value.shape[2] < 1:
        raise ValueError(f"empty text or frame axis: {tuple(value.shape)}")
    if mask.dtype not in _TYPE_CODES:
        mask = mask.float()
    return value, mask


def mask_lengths(mask: torch.Tensor):
    """(x_len, y_len), each (B,) int32: the mask's column 0 and row 0 summed,
    truncated, clamped to [1, t]."""
    _, tx, ty = mask.shape
    x_len = mask[:, :, 0].float().sum(1).to(torch.int32).clamp(1, tx)
    y_len = mask[:, 0, :].float().sum(1).to(torch.int32).clamp(1, ty)
    return x_len, y_len


def maximum_path_reference(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``maximum_path`` on any device."""
    value, mask = _prepare(value, mask)
    out_dtype = value.dtype
    B, tx, ty = value.shape
    neg_inf = torch.tensor(float("-inf"), device=value.device)
    m = mask.float()
    v = torch.where(m > 0, value.float(), neg_inf)
    x_len, y_len = (t.long() for t in mask_lengths(mask))

    ar = torch.arange(tx, device=value.device)
    q = torch.where(ar[None, :] == 0, v[:, :, 0], neg_inf)
    diag = torch.zeros((B, ty, tx), dtype=torch.bool, device=value.device)
    for y in range(1, ty):
        shifted = torch.cat([neg_inf.expand(B, 1), q[:, :-1]], dim=1)
        diag[:, y] = shifted >= q
        q = v[:, :, y] + torch.maximum(shifted, q)

    path = torch.zeros((B, tx, ty), dtype=torch.float32, device=value.device)
    rows = torch.arange(B, device=value.device)
    x = torch.zeros(B, dtype=torch.long, device=value.device)
    for y in range(ty - 1, -1, -1):
        active = y < y_len
        x = torch.where(y == y_len - 1, x_len - 1, x)
        path[:, :, y] = ((ar[None, :] == x[:, None]) & active[:, None]).float()
        if y > 0:
            # The bit of an x below 0 (reached only through -inf scores in
            # row 0), as xva_trainer_tpu/ops/mas.py:81's take_along_axis
            # reads it: x in [-t_x, -1] at x + t_x, x < -t_x as True (its
            # fill value for booleans), so the walk goes on stepping down.
            inside = torch.where(x < 0, x + tx, x).clamp(min=0)
            took = torch.where(x < -tx, True, diag[rows, y, inside]).long()
            x = torch.where(active, x - took, x)
    return (path * m).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = _cuda.load(KERNEL)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mas_forward.argtypes = [p, p, p, p, p, p] + [i32] * 8 + [p]
    lib.mas_forward.restype = ctypes.c_int
    lib.mas_error_string.argtypes = [ctypes.c_int]
    lib.mas_error_string.restype = ctypes.c_char_p
    return lib


class Plan(NamedTuple):
    """The kernel's layout for one shape: frames a staged tile, stages in the
    ring, whether the direction bits stay in shared memory, and the block's
    shared bytes."""
    frames: int
    stages: int
    dirs_shared: bool
    shared_bytes: int


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def chunk(tx: int) -> int:
    """Text positions a lane holds (K, odd): lane l of warp w holds
    x = K(32w + l) + k, k < K; one warp covers 32·K positions, and t_x > 288
    takes ceil(t_x / 288) warps of K = 9."""
    return 1 if tx <= 32 else 3 if tx <= 96 else 5 if tx <= 160 else 7 if tx <= 224 else 9


def _dirs_shape(tx: int, scratch: bool = False):
    """(lanes, bytes) of one frame's direction bits: a word of K bits a lane,
    one byte for K <= 8, two for K = 9. Bits kept in scratch are always the
    multi-warp kernel's, whose K is 9."""
    k = 9 if scratch else chunk(tx)
    return 32 * -(-tx // (32 * k)), 2 if k > 8 else 1


def shared_bytes(tx: int, ty: int, value_bytes: int = 4, mask_bytes: int = 4,
                 frames: int = 32, stages: int = 3, dirs_shared: bool = True) -> int:
    """Shared memory of one block, as csrc/mas.cu lays it out: the ring of
    staged tiles (t_x rows of value and of mask, each row F + 4 elements:
    an odd number of 16-byte units for fp32, 8-byte units for bf16), the
    direction bits (a word of K bits a lane a frame), the path's x per frame
    and the warps' boundary scores."""
    lanes, bits = _dirs_shape(tx)
    row = frames + 4
    stage = _a16(tx * row * value_bytes) + _a16(tx * row * mask_bytes)
    return (stages * stage + (_a16(ty * lanes * bits) if dirs_shared else 0) + _a16(4 * ty)
            + _a16(8 * lanes // 32))


def plan(tx: int, ty: int, value_bytes: int = 4, mask_bytes: int = 4) -> Plan | None:
    """The largest layout that fits a block, direction bits in shared memory
    first (every v3 bucket and FastPitch's 256 x 896 keep them there); None if
    none fits."""
    for dirs_shared in (True, False):
        for frames, stages in ((32, 3), (16, 3), (16, 2), (8, 2)):
            n = shared_bytes(tx, ty, value_bytes, mask_bytes, frames, stages, dirs_shared)
            if n <= MAX_SHARED_BYTES:
                return Plan(frames, stages, dirs_shared, n)
    return None


def _launch(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if value.dtype not in _TYPE_CODES:
        raise ValueError(f"the MAS kernel takes float32 or bfloat16 values, got {value.dtype}")
    B, tx, ty = value.shape
    mask = mask.to(value.device)
    layout = plan(tx, ty, value.element_size(), mask.element_size())
    if layout is None:
        raise ValueError(f"t_x={tx}, t_y={ty} needs more shared memory than a block has "
                         f"({MAX_SHARED_BYTES} bytes) even with 8-frame tiles")
    value, mask = value.contiguous(), mask.contiguous()
    x_len, y_len = mask_lengths(mask)
    path = torch.empty_like(value)
    if B == 0:  # nothing to launch, so nothing to count
        return path
    scratch = None if layout.dirs_shared else torch.empty(
        (B, ty, *_dirs_shape(tx, scratch=True)), dtype=torch.uint8, device=value.device)
    lib = _lib()
    with torch.cuda.device(value.device):
        rc = lib.mas_forward(value.data_ptr(), mask.data_ptr(), x_len.data_ptr(),
                             y_len.data_ptr(), path.data_ptr(),
                             None if scratch is None else scratch.data_ptr(), B, tx, ty,
                             _TYPE_CODES[value.dtype], _TYPE_CODES[mask.dtype], layout.frames,
                             layout.stages, layout.shared_bytes,
                             torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mas kernel launch failed: CUDA error {rc} "
                           f"({lib.mas_error_string(rc).decode()})")
    _cuda.LAUNCHES[KERNEL] += 1
    return path


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Best monotonic alignment path.

    value: (B, t_x, t_y) log-likelihoods (text positions x mel frames), fp32
    or bf16; mask: (B, t_x, t_y), the outer product of the two length masks.
    Returns the (B, t_x, t_y) path in value's type: 1 on the path (times the
    mask), 0 elsewhere. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    value, mask = _prepare(value, mask)
    if value.device.type == "cuda":
        return _launch(value, mask)
    if value.device.type == "cpu":
        return maximum_path_reference(value, mask)
    raise ValueError(f"unsupported device {value.device}")
