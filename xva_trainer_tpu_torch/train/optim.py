"""The GAN optimisers of the xVAPitch trainer, as ``optax`` computes them.

Counterpart of ``xva_trainer_tpu/train/optim.py::make_gan_optimizer``:

- AdamW with betas (0.8, 0.99), eps 1e-8 and decoupled weight decay 0.01
  applied to every parameter, as ``optax.adamw``: u = m̂ / (sqrt(v̂) + eps)
  + wd·p, p ← p - lr·u, with bias corrections 1 - β^t;
- Lion (``torch.optim`` has none), as ``optax.lion``: u = sign((1-β1) g +
  β1 m) + wd·p, then m ← (1-β2) g + β2 m; with the reference's lr/5 and wd×5
  (training_util.py:45-51);
- the schedule lr·γ^(t // decay_every), t the count of updates made so far;
- gradient accumulation with ``optax.MultiSteps`` semantics: the running
  mean of ``grad_accum`` micro-steps' gradients, one update of the inner
  optimiser (and one advance of its count) each ``grad_accum`` calls, no
  change to the parameters in between.

A gradient of ``None`` (a parameter the loss does not reach) counts as
zeros, as JAX's gradients are: Adam's moments still decay and the weight
decay still applies. ``step(grads, apply_mask)`` computes the update of
every parameter, advances every state, and applies the update only where the
mask is True (the trainer's freezes). The arithmetic runs as
``torch._foreach_*`` ops, a few launches for the whole parameter list.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class GanOptimizer:
    """AdamW (default) or Lion over ``params``, with the per-``decay_every``
    exponential decay and ``grad_accum``-step accumulation."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, *,
                 betas=(0.8, 0.99), weight_decay: float = 0.01, gamma: float = 0.999875,
                 decay_every: int = 1, grad_accum: int = 1, kind: str = "adamw",
                 eps: float = 1e-8):
        if kind == "lion":
            lr, weight_decay = lr / 5.0, weight_decay * 5.0
        elif kind != "adamw":
            raise ValueError(f"unknown optimizer kind {kind!r} (expected 'adamw' or 'lion')")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.params = list(params)
        self.kind, self.lr, self.betas, self.eps = kind, lr, betas, eps
        self.weight_decay, self.gamma, self.decay_every = weight_decay, gamma, decay_every
        self.grad_accum = grad_accum
        self.count = 0       # updates made (the inner optimiser's count)
        self.mini_step = 0   # micro-steps accumulated toward the next update
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params] if kind == "adamw" else None
        self.acc = [torch.zeros_like(p) for p in self.params] if grad_accum > 1 else None

    def state_dict(self) -> dict:
        """The optimiser's state (optax's inner state with ``MultiSteps``'):
        the moments ``mu`` and ``nu``, the accumulated gradient ``acc``, the
        update ``count`` and the micro-step ``mini_step``, as references to
        the live tensors (``torch.save`` copies them)."""
        return {"kind": self.kind, "grad_accum": self.grad_accum, "count": self.count,
                "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s state into this optimiser's tensors
        (same kind, accumulation and parameter shapes), bit for bit."""
        if (state["kind"], state["grad_accum"]) != (self.kind, self.grad_accum):
            raise ValueError(f"a {state['kind']} state with grad_accum {state['grad_accum']} "
                             f"for a {self.kind} optimiser with grad_accum {self.grad_accum}")
        for name in ("mu", "nu", "acc"):
            ours, theirs = getattr(self, name), state[name]
            if ours is None:
                continue
            if len(theirs) != len(ours) or any(a.shape != b.shape for a, b in zip(ours, theirs)):
                raise ValueError(f"the saved {name} does not match the parameters' shapes")
            for a, b in zip(ours, theirs):
                a.copy_(b)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    def learning_rate(self, count: Optional[int] = None) -> float:
        """lr·γ^(count // decay_every) at update ``count`` (default: the next)."""
        count = self.count if count is None else count
        return self.lr * self.gamma ** (count // self.decay_every)

    def _dense(self, grads) -> List[torch.Tensor]:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        return [torch.zeros_like(p) if g is None else g.to(p.dtype)
                for g, p in zip(grads, self.params)]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]],
             apply_mask: Optional[Sequence[bool]] = None) -> bool:
        """One micro-step. Returns True when it updated the parameters."""
        grads = self._dense(grads)
        if self.acc is not None:
            # running mean, as optax.MultiSteps: acc += (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            if self.mini_step < self.grad_accum - 1:
                self.mini_step += 1
                return False
            grads, self.acc = self.acc, [torch.zeros_like(p) for p in self.params]
            self.mini_step = 0
        updates = self._updates(grads)
        torch._foreach_mul_(updates, -self.learning_rate())
        self.count += 1
        if apply_mask is None:
            torch._foreach_add_(self.params, updates)
        else:
            pairs = [(p, u) for p, u, keep in zip(self.params, updates, apply_mask) if keep]
            if pairs:
                torch._foreach_add_([p for p, _ in pairs], [u for _, u in pairs])
        return True

    def _updates(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The update direction before the learning rate, advancing the
        moments."""
        b1, b2 = self.betas
        if self.kind == "lion":
            upd = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(upd, self.mu, alpha=b1)
            upd = [torch.sign(u) for u in upd]
            torch._foreach_mul_(self.mu, b2)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b2)
        else:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
            t = self.count + 1
            denom = torch._foreach_div(self.nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(self.mu, 1.0 - b1 ** t)
            torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        return upd

