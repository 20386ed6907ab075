"""Tensor parallelism over the mesh's "model" axis: the Megatron split of the
conv FFNs.

Counterpart of ``xva_trainer_tpu/parallel/tp.py``. JAX maps parameter paths
to ``PartitionSpec``s and lets XLA insert the all-reduces; torch's
``ColwiseParallel``/``RowwiseParallel`` take ``nn.Linear`` only, so the
split of the conv FFNs is written here:

- the first FFN conv, weight (d_ff, d_model, k), is cut on its OUTPUT
  channels with its bias ("column parallel"): each model rank computes
  d_ff / n of the hidden activations;
- the second, weight (d_model, d_ff, k), is cut on its INPUT channels
  ("row parallel"), its bias replicated: the partial sums are all-reduced
  over the model group, then the bias is added.

The FFN's input goes through ``f`` (identity forward, all-reduce of the
gradient backward), its row-parallel output through ``g`` (all-reduce
forward, identity backward), so every other parameter sees the replicated
model's gradient. A dropout on the sharded hidden (xVAPitch's FFN) takes its
channels' slice of the replicated mask (``parallel/draws.py``). LAMB's trust
ratio (``train/optim.py``) sums the squares of a sharded tensor over the
model group, so that the ratio is the whole tensor's.

A spec is a tuple with one entry per dimension: "model" where the dimension
is cut, None elsewhere; () is replicated. A dimension that does not divide
the model axis stays replicated.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.fastpitch.layers import PositionwiseConvFF
from ..models.xvapitch.layers import FeedForwardNetwork, dropout
from . import draws

Spec = Tuple

# (parameter-name regex, spec): first match wins; the rest is replicated.
# Conv weights are (out, in, k).
FASTPITCH_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*pos_ff\.CoreNet\.0\.weight$", ("model", None, None)),
    (r".*pos_ff\.CoreNet\.0\.bias$", ("model",)),
    (r".*pos_ff\.CoreNet\.2\.weight$", (None, "model", None)),
]

# xVAPitch's conv FFNs (RelativePositionTransformer): the same split.
XVAPITCH_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*ffn_layers\.\d+\.conv_1\.weight$", ("model", None, None)),
    (r".*ffn_layers\.\d+\.conv_1\.bias$", ("model",)),
    (r".*ffn_layers\.\d+\.conv_2\.weight$", (None, "model", None)),
]


def tp_pspecs(model: nn.Module, rules: Sequence[Tuple[str, Spec]]) -> "OrderedDict[str, Spec]":
    """Parameter name → the spec of the first matching rule, or ()."""
    compiled = [(re.compile(rx), spec) for rx, spec in rules]
    out: "OrderedDict[str, Spec]" = OrderedDict()
    for name, _ in model.named_parameters():
        out[name] = next((spec for rx, spec in compiled if rx.match(name)), ())
    return out


class _CopyToModel(torch.autograd.Function):
    """``f``: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _f(x, group):
    return x if group is None else _CopyToModel.apply(x, group)


def _g(x, group):
    return x if group is None else _ReduceFromModel.apply(x, group)


class TPPositionwiseConvFF(PositionwiseConvFF):
    """FastPitch's conv FFN with CoreNet.0 column- and CoreNet.2
    row-parallel (set by ``shard_params``)."""

    tp_group = None

    def forward(self, x, generator=None):
        c0, c2 = self.CoreNet[0], self.CoreNet[2]
        h = torch.relu(c0(_f(x.transpose(1, 2), self.tp_group)))
        h = _g(c2._conv_forward(h, c2.weight, None), self.tp_group) + c2.bias[:, None]
        h = dropout(h.transpose(1, 2), self.p_dropout, self.training, generator)
        return self.layer_norm(x + h)


class TPFeedForwardNetwork(FeedForwardNetwork):
    """xVAPitch's conv FFN with conv_1 column- and conv_2 row-parallel; the
    hidden's dropout takes its channels of the replicated mask."""

    tp_group = None
    tp_index, tp_count = 0, 1

    def forward(self, x, x_mask, generator=None):
        x = _f(x, self.tp_group)
        h = torch.relu(self.conv_1(F.pad(x * x_mask, self.pad)))
        gen = draws.channel_draws(generator, 1, self.tp_index, self.tp_count)
        h = dropout(h, self.dropout_p, self.training, gen)
        y = self.conv_2._conv_forward(F.pad(h * x_mask, self.pad), self.conv_2.weight, None)
        return (_g(y, self.tp_group) + self.conv_2.bias[:, None]) * x_mask


_TP_CLASSES = {PositionwiseConvFF: (TPPositionwiseConvFF, "CoreNet.0.weight"),
               FeedForwardNetwork: (TPFeedForwardNetwork, "conv_1.weight")}


def shard_params(model: nn.Module, mesh, rules: Sequence[Tuple[str, Spec]]) -> nn.Module:
    """Cut each parameter that a rule matches to this rank's block along the
    spec's dimension (block ``mesh.model_index`` of ``mesh.n_model``), in
    place, and switch each FFN whose weights were cut to its tensor-parallel
    forward. A spec whose dimension does not divide the model axis is
    demoted to replicated. Each cut parameter carries ``tp_spec``, and
    ``tp_group`` (the model group, None on a model axis of 1). Make the
    optimiser after this: its state takes the blocks' shapes."""
    n, i = mesh.n_model, mesh.model_index
    group = mesh.model_group if n > 1 else None
    specs = tp_pspecs(model, rules)
    cut = set()
    for name, p in model.named_parameters():
        spec = specs[name]
        if "model" not in spec:
            continue
        dim = spec.index("model")
        if dim >= p.ndim or p.shape[dim] % n:
            continue
        size = p.shape[dim] // n
        with torch.no_grad():
            p.data = p.data.narrow(dim, i * size, size).clone()
        p.tp_spec, p.tp_group = spec, group
        cut.add(name)
    for mname, mod in model.named_modules():
        tp_cls, key = _TP_CLASSES.get(type(mod), (None, None))
        if tp_cls is not None and f"{mname}.{key}" in cut:
            mod.__class__ = tp_cls
            mod.tp_group, mod.tp_index, mod.tp_count = group, i, n
    return model


def sharding_summary(model: nn.Module) -> Dict[str, str]:
    """Parameter name → spec string for every parameter that is cut."""
    return {name: str(p.tp_spec) for name, p in model.named_parameters()
            if getattr(p, "tp_spec", ())}


def gather_params(model: nn.Module, mesh) -> "OrderedDict[str, torch.Tensor]":
    """The whole parameters (each cut one reassembled from the model
    group's blocks), detached copies, by name."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, p in model.named_parameters():
        spec = getattr(p, "tp_spec", ())
        if not spec or mesh.n_model == 1:
            out[name] = p.detach().clone()
            continue
        dim = spec.index("model")
        shape = list(p.shape)
        shape[dim] *= mesh.n_model
        full = torch.zeros(shape, dtype=p.dtype, device=p.device)
        full.narrow(dim, mesh.model_index * p.shape[dim], p.shape[dim]).copy_(p.detach())
        dist.all_reduce(full, group=mesh.model_group)
        out[name] = full
    return out
