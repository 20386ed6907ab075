"""Split the MAS kernel's time by phase on one NVIDIA GPU.

    python3 scripts/probe_mas.py [--parent DIR]

Writes copies of ``xva_trainer_tpu_torch/csrc/mas.cu`` into
``build/probe_mas/`` with ``clock64()`` stamps added: block 0 writes, into
the first six entries of its path, the cycles of the prologue (the first
tile staged), of the tile loop, the DP warp's own work in it, the backtrack,
and the first producer thread's work and its issue time before each wait.
Beside the stamped copy it builds the source as it is and two ablations of
the stamped copy: one without the direction bits' store (so the compiler
drops the bit logic) and one without the shuffle between lanes. Their paths
are wrong; their times say what those parts cost. It holds the package's
own kernel to the plain version, then times the wrapper's call (lengths and
launch) and every build's launch at ``chip_smoke.py``'s trainer case
(64 x 192 x 768 fp32, ragged) by CUDA graph replay with the L2 cache evicted
(``chip_smoke.device_ms``), in turns, forward then back.

``--parent DIR`` also builds ``DIR/xva_trainer_tpu_torch/csrc/mas.cu``, the
kernel of an earlier checkout whose C function takes (value, mask, x_lens,
y_lens, path, batch, t_x, t_y, value type, mask type, stream), and times it
in the same turns on the same inputs.

It also disassembles the package's library (``cuobjdump -sass``) and counts
the instructions of one frame of the fp32 one-warp kernel at the trainer's
K = 7: those between its frame loop's first two shuffles, by opcode.

Prints one JSON line and, last, the card's name and power limit. The
replacements are of lines of the source: an edit there that moves one makes
this script fail with the line it did not find.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = REPO / "xva_trainer_tpu_torch" / "csrc" / "mas.cu"
OUT = REPO / "build" / "probe_mas"
STAMPS = [
    ("  extern __shared__ __align__(16) unsigned char smem[];",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  long long T0 = clock64(), T1 = 0, T2 = 0, T3 = 0, Tc = 0, Tp = 0, Tpi = 0;"),
    ("  __syncthreads();\n\n  float q[K];",
     "  __syncthreads();\n  T1 = clock64();\n\n  float q[K];"),
    ("  for (int t = 0; t < n_tiles; ++t) {\n    if (is_dp) {",
     "  for (int t = 0; t < n_tiles; ++t) {\n    long long ta = clock64();\n    if (is_dp) {"),
    ("      if (stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();\n"
     "      mask_landed(t + 1);\n    }\n    __syncthreads();",
     "      Tpi += clock64() - ta;\n"
     "      if (stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();\n"
     "      mask_landed(t + 1);\n    }\n"
     "    if (is_dp) Tc += clock64() - ta; else Tp += clock64() - ta;\n    __syncthreads();"),
    ("  if (threadIdx.x == 0) {  // the backtrack", "  T2 = clock64();\n"
     "  if (threadIdx.x == 0) {  // the backtrack"),
    ("  __syncthreads();\n\n  for (int y = threadIdx.x; y < y_len;",
     "  __syncthreads();\n  T3 = clock64();\n\n  for (int y = threadIdx.x; y < y_len;"),
    ("      out[i] = from_float<TV>(to_float(m[i]));\n    }\n  }\n}",
     "      out[i] = from_float<TV>(to_float(m[i]));\n    }\n  }\n  __syncthreads();\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    out[0] = from_float<TV>((float)(T1 - T0));\n"
     "    out[1] = from_float<TV>((float)(T2 - T1));\n"
     "    out[2] = from_float<TV>((float)Tc);\n"
     "    out[3] = from_float<TV>((float)(T3 - T2));\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 32 * W) {\n"
     "    out[4] = from_float<TV>((float)Tp);\n"
     "    out[5] = from_float<TV>((float)Tpi);\n  }\n}"),
]
STAMP_NAMES = ["prologue", "tile_loop", "dp_warp_work", "backtrack", "producer_work",
               "producer_issue"]
VARIANTS = {  # None: the source as it is
    "unstamped": None,
    "stamped": [],
    "no_bit_store": [("my_dirs[(size_t)y * R] = (Bits)bits;",
                      "if (bits == 12345u) my_dirs[(size_t)y * R] = 0;")],
    "no_shuffle": [("float up = __shfl_up_sync(FULL, q[K - 1], 1);", "float up = q[K - 1];")],
}
ROUNDS = 2


def nvcc_build(src: Path, stem: str) -> Path:
    from xva_trainer_tpu_torch.ops._cuda import NVCC_FLAGS

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = OUT / f"{stem}.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(so), str(src)], capture_output=True,
                          text=True, timeout=900, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {stem} failed:\n{proc.stdout}{proc.stderr}")
    return so


def build_variant(name: str) -> Path:
    src = SOURCE.read_text()
    for old, new in [] if VARIANTS[name] is None else STAMPS + VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{SOURCE} no longer holds:\n{old}")
        src = src.replace(old, new, 1)
    (OUT / f"{name}.cu").write_text(src)
    return nvcc_build(OUT / f"{name}.cu", name)


def frame_mix(library: Path) -> dict:
    """Opcode counts between the first two SHFL.UP of the fp32/fp32, K = 7,
    one-warp kernel's SASS: one frame of its DP."""
    cuobjdump = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    (OUT / "mas.sass").write_text(sass)
    func = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in func if re.match(r"\S*mas_kernelIffLi7ELb0E", f))
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
    shfl = [i for i, op in enumerate(ops) if op == "SHFL"]
    frame = ops[shfl[0]:shfl[1]]
    return {"instructions": len(frame), "by_opcode": dict(Counter(frame).most_common())}


def bind(so: Path, parent: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mas_forward.argtypes = ([p] * 5 + [i32] * 5 + [p]) if parent else \
        ([p] * 6 + [i32] * 8 + [p])
    lib.mas_forward.restype = i32
    lib.mas_error_string.argtypes = [i32]
    lib.mas_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout whose csrc/mas.cu is timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mas: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from xva_trainer_tpu_torch.ops import _cuda, mas

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        own = pool.submit(_cuda.build, mas.KERNEL)
        parent = pool.submit(nvcc_build, Path(args.parent) / "xva_trainer_tpu_torch" / "csrc"
                             / "mas.cu", "parent") if args.parent else None
        libs = {name: bind(so, False)
                for name, so in zip(VARIANTS, pool.map(build_variant, VARIANTS))}
        own.result()
        if parent is not None:
            libs["parent"] = bind(parent.result(), True)

    dev = torch.device("cuda")
    flush = torch.zeros(64 * 2 ** 20 // 4, device=dev)
    value, mask = cs.mas_case("trainer", dev)
    B, tx, ty = value.shape
    x_len, y_len = mas.mask_lengths(mask)
    path = torch.empty_like(value)
    equal = bool(torch.equal(mas.maximum_path(value, mask), mas.maximum_path_reference(value,
                                                                                         mask)))

    def call(name):
        if name == "own":
            return lambda: mas.maximum_path(value, mask)
        lib = libs[name]
        if name == "parent":  # the earlier interface: lengths made by the caller
            return lambda: lib.mas_forward(
                value.data_ptr(), mask.data_ptr(), x_len.data_ptr(), y_len.data_ptr(),
                path.data_ptr(), B, tx, ty, 0, 0, torch.cuda.current_stream().cuda_stream)
        layout = mas.plan(tx, ty)
        return lambda: lib.mas_forward(
            value.data_ptr(), mask.data_ptr(), x_len.data_ptr(), y_len.data_ptr(),
            path.data_ptr(), None, B, tx, ty, 0, 0, layout.frames, layout.stages,
            layout.shared_bytes, torch.cuda.current_stream().cuda_stream)

    names = ["own", *libs]
    device_ms = {name: [] for name in names}
    for order in [names, names[::-1]] * (ROUNDS // 2):
        for name in order:
            device_ms[name].append(cs.device_ms(call(name), flush))
    cycles = {}
    for name in (n for n, edits in VARIANTS.items() if edits is not None):
        call(name)()
        torch.cuda.synchronize()
        cycles[name] = dict(zip(STAMP_NAMES, path[0, 0, :6].tolist()))
    print(json.dumps({"shape": [B, tx, ty], "own_equals_plain": equal, "device_ms": device_ms,
                      "cycles_block_0": cycles,
                      "frame_sass": frame_mix(_cuda.library_path(mas.KERNEL))}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
