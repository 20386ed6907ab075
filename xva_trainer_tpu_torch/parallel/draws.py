"""Random draws for the global batch, sliced to one rank's share.

Under data parallelism a rank holds a contiguous slice of the global batch,
yet its step must draw what the one-process step on the global batch draws.
``ShardDraws`` wraps the step's ``torch.Generator``: every draw is made at
the global batch's shape (the local batch's rows times the data axis; under
tensor parallelism also a channel dimension times the model axis) from the
same generator state on every rank, and the rank keeps its rows (and
channels). The generators of all ranks therefore stay in step, and the
masks and noise are the one-process step's, row for row.

The draw sites of the models (``models/xvapitch/layers.py::dropout``,
``modules.py::standard_normal``, ``model.py::rand_segments``) call ``rand``
and ``randn`` here, which take a plain generator or a ``ShardDraws``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class ShardDraws:
    """A generator whose draws are made for the global batch and sliced:
    rows ``[index·b, (index+1)·b)`` of ``count`` equal slices of dim 0, and,
    with ``channel = (dim, index, count)``, that slice of ``dim`` too."""

    def __init__(self, generator: torch.Generator, index: int = 0, count: int = 1,
                 channel: Optional[Tuple[int, int, int]] = None):
        self.generator = generator
        self.device = generator.device
        self.index, self.count, self.channel = index, count, channel

    def channels(self, dim: int, index: int, count: int) -> "ShardDraws":
        """The same rows, and slice ``index`` of ``count`` along ``dim``."""
        return ShardDraws(self.generator, self.index, self.count, (dim, index, count))

    def draw(self, fn, shape: Sequence[int]) -> torch.Tensor:
        full = list(shape)
        full[0] *= self.count
        if self.channel is not None:
            full[self.channel[0]] *= self.channel[2]
        t = fn(tuple(full), generator=self.generator, device=self.device)
        b = shape[0]
        t = t[self.index * b:(self.index + 1) * b]
        if self.channel is not None:
            dim, i, _ = self.channel
            t = t.narrow(dim, i * shape[dim], shape[dim])
        return t


def shard_draws(generator: Optional[torch.Generator], index: int, count: int):
    """``generator`` itself for one slice (the one-process step draws as it
    always did), else its ``ShardDraws`` for slice ``index`` of ``count``."""
    if generator is None or count == 1:
        return generator
    return ShardDraws(generator, index, count)


def channel_draws(generator, dim: int, index: int, count: int):
    """Draws of ``generator`` (plain or sharded by rows) sliced along ``dim``
    as well: slice ``index`` of ``count`` (a tensor-parallel hidden's share
    of the replicated mask)."""
    if generator is None or count == 1:
        return generator
    if not isinstance(generator, ShardDraws):
        generator = ShardDraws(generator)
    return generator.channels(dim, index, count)


def rand(shape, generator) -> torch.Tensor:
    """U[0, 1) of ``shape`` on ``generator``'s device."""
    if isinstance(generator, ShardDraws):
        return generator.draw(torch.rand, shape)
    return torch.rand(shape, generator=generator, device=generator.device)


def randn(shape, generator) -> torch.Tensor:
    """N(0, 1) of ``shape`` on ``generator``'s device."""
    if isinstance(generator, ShardDraws):
        return generator.draw(torch.randn, shape)
    return torch.randn(shape, generator=generator, device=generator.device)
