"""Declarative torch<->flax parameter mapping: flax params into the port.

The port's own copy of the rule machinery of
``xva_trainer_tpu/interop/mapping.py`` (the port imports nothing of the JAX
package). Each Rule binds one torch state-dict entry (or a weight-norm g/v
pair) to one flax param path with a layout kind; ``apply_carry`` turns
nested flax variables, as numpy arrays, into a flat torch-named state dict
of the port's modules.

Layout kinds (flax shape -> torch shape):
- conv1d:   (k, in, out)      -> (out, in, k)
- convT1d:  (k, in, out)      -> (in, out, k) + spatial flip
            (torch ConvTranspose1d with padding (k-u)//2 equals flax 'SAME')
- conv2d:   (kh, kw, in, out) -> (out, in, kh, kw)
- convT2d:  (kh, kw, in, out) -> (in, out, kh, kw) + flip of both spatial axes
            (flax ConvTranspose 'SAME' at stride 2 equals torch
            ConvTranspose2d with padding (k-1)//2 and the last column dropped)
- linear:   (in, out)         -> (out, in)
- embed/id: unchanged
- flat:     reshape to ``tshape`` (ElementwiseAffine (C,) -> (C, 1))

Weight-normed convs ("wn_" prefix) are joint rules over (kernel, scale) ->
(weight_v, weight_g), carried as they are: ``weight_v`` the kernel in torch
layout, ``weight_g`` the scale, each normalised over the output axis as
flax does (dim 1 for the transposed conv). The same gradients of the
effective weight then move (g, v) as they move flax's (scale, kernel). (The
JAX package's export re-splits the pair torch's way, g = ||w|| and v = w,
over dim 0: the reference's file layout, which ``convert.ups_from_reference``
reads.)
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FlaxPath = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Rule:
    torch_key: str          # without the .weight/.weight_g suffix for wn kinds
    flax_path: FlaxPath     # path of the kernel/value under params["params"]
    kind: str = "id"
    scale_path: Optional[FlaxPath] = None  # wn kinds: path of the WeightNorm scale
    tshape: Optional[Tuple[int, ...]] = None  # export reshape for 'flat'
    collection: str = "params"  # flax variable collection (e.g. batch_stats)


def _f2t(w: np.ndarray, kind: str, tshape=None) -> np.ndarray:
    if kind == "conv1d":
        return np.transpose(w, (2, 1, 0))
    if kind == "convT1d":
        return np.transpose(w[::-1], (1, 2, 0))
    if kind == "conv2d":
        return np.transpose(w, (3, 2, 0, 1))
    if kind == "convT2d":
        return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
    if kind == "linear":
        return np.transpose(w)
    if kind == "flat":
        return w.reshape(tshape) if tshape is not None else w
    return w


def _get_path(tree: Dict, path: FlaxPath):
    node = tree
    for p in path:
        node = node[p]
    return node


def apply_carry(params: Dict, rules: Sequence[Rule]) -> "OrderedDict[str, np.ndarray]":
    """Nested flax variables (numpy leaves) -> flat torch-named fp32 state
    dict of the port's modules (writable, contiguous copies), with each
    weight-norm (kernel, scale) pair carried as (weight_v, weight_g)."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for r in rules:
        tree = params.get("params", params) if r.collection == "params" else params[r.collection]
        w = np.asarray(_get_path(tree, r.flax_path), np.float32)
        if r.kind.startswith("wn_"):
            kind = r.kind[3:]
            v = _f2t(w, kind)
            shape = [1] * v.ndim
            shape[1 if kind == "convT1d" else 0] = -1
            scale = np.asarray(_get_path(tree, r.scale_path), np.float32)
            out[r.torch_key + ".weight_g"] = np.array(scale.reshape(shape))
            out[r.torch_key + ".weight_v"] = np.array(v, order="C")
        else:
            out[r.torch_key] = np.array(_f2t(w, r.kind, r.tshape), order="C")
    return out
