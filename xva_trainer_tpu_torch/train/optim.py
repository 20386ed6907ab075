"""The optimisers of the trainers, as ``optax`` computes them.

Counterpart of ``xva_trainer_tpu/train/optim.py``: ``make_gan_optimizer``
(the xVAPitch trainer's ``GanOptimizer``, below) and
``make_fastpitch_optimizer`` (FastPitch's ``LambOptimizer``, at the end).
The GAN optimisers:

- AdamW with betas (0.8, 0.99), eps 1e-8 and decoupled weight decay 0.01
  applied to every parameter, as ``optax.adamw``: u = m̂ / (sqrt(v̂) + eps)
  + wd·p, p ← p - lr·u, with bias corrections 1 - β^t;
- Lion (``torch.optim`` has none), as ``optax.lion``: u = sign((1-β1) g +
  β1 m) + wd·p, then m ← (1-β2) g + β2 m; with the reference's lr/5 and wd×5
  (training_util.py:45-51);
- the schedule lr·γ^(t // decay_every), t the count of updates made so far;
  with γ = 1 the learning rate is ``lr`` itself, which the caller may set
  between steps (the HiFi-GAN trainer's per-epoch decay, optax's
  ``inject_hyperparams``), and which ``state_dict`` carries;
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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


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
        update ``count``, the micro-step ``mini_step`` and the learning rate
        ``lr``, the tensors as references to the live ones (``torch.save``
        copies them)."""
        return {"kind": self.kind, "grad_accum": self.grad_accum, "count": self.count,
                "mini_step": self.mini_step, "lr": self.lr, "mu": self.mu, "nu": self.nu,
                "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s state into this optimiser's tensors
        (same kind, accumulation and parameter shapes), bit for bit. A state
        without ``lr`` (a checkpoint written before it was saved) keeps this
        optimiser's."""
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
        self.lr = float(state.get("lr", self.lr))

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



# ---------------- FastPitch: LAMB with the Noam warm-up ----------------

# the modules each FastPitch stage freezes (reference xva_train.py:589-672)
_STAGE_FROZEN_MODULES = {
    1: ["duration_predictor", "decoder", "pitch_predictor", "pitch_emb",
        "energy_predictor", "energy_emb", "proj"],
    2: ["attention", "decoder", "pitch_predictor", "pitch_emb",
        "energy_predictor", "energy_emb", "proj"],
    3: ["attention", "duration_predictor"],
    4: ["attention", "duration_predictor", "pitch_predictor", "pitch_emb",
        "energy_predictor", "energy_emb"],
}


def fastpitch_stage_mask(model: torch.nn.Module, stage: int) -> List[bool]:
    """Per parameter (``model.named_parameters()`` order): True where stage
    ``stage`` trains it, False where it is frozen (JAX's 'train'/'freeze'
    labels)."""
    frozen = _STAGE_FROZEN_MODULES[stage]
    return [name.split(".", 1)[0] not in frozen for name, _ in model.named_parameters()]


def noam_warmup_schedule(base_lr: float, warmup_steps: int):
    """count → lr·count/warmup^1.5 during the warm-up, lr/sqrt(count) after,
    with count clamped to at least 1, in float32 as JAX computes it."""

    def schedule(count: int) -> np.float32:
        step = np.float32(max(count, 1))
        if warmup_steps == 0:
            return np.float32(base_lr)
        if step > warmup_steps:
            scale = np.float32(1.0) / np.sqrt(step)
        else:
            scale = step / np.float32(warmup_steps ** 1.5)
        return np.float32(np.float32(base_lr) * scale)

    return schedule


def _whole_tensor_norms(params, p_norm: List, u_norm: List) -> None:
    """Replace the norms of tensor-parallel blocks (``parallel/tp.py``:
    parameters with a ``tp_group``) by their whole tensors' norms: the
    squares summed over the model group, in one all-reduce."""
    cut = [i for i, p in enumerate(params) if getattr(p, "tp_group", None) is not None]
    if not cut:
        return
    sq = torch.stack([p_norm[i] for i in cut] + [u_norm[i] for i in cut]) ** 2
    dist.all_reduce(sq, group=params[cut[0]].tp_group)
    whole = torch.sqrt(sq)
    for j, i in enumerate(cut):
        p_norm[i], u_norm[i] = whole[j], whole[len(cut) + j]


class LambOptimizer:
    """FastPitch's optimiser as ``make_fastpitch_optimizer`` builds it in
    optax: ``MultiSteps(multi_transform({"train": lamb, "freeze":
    set_to_zero}, mask), every_k_schedule=grad_accum)``, with
    ``optax.lamb``'s chain ``scale_by_adam(b1, b2, eps, eps_root=0)`` →
    ``add_decayed_weights(wd)`` → ``scale_by_trust_ratio`` (per tensor:
    ||p|| / ||u||, 1 where either norm is 0) → the Noam learning rate.

    - A gradient of None counts as zeros for every trained parameter: its
      moments decay and its weight decay applies, and through the trust
      ratio a parameter with a zero gradient moves by -lr·p. (In stage 1 the
      encoder's attention and FF layers are trained and get no gradient, so
      they shrink by (1 - lr) each update, as in JAX.)
    - Frozen parameters (``train_mask`` False) get zero updates; their
      gradients still enter the accumulator, as they do in optax.
    - ``reset()`` re-initialises the whole state, moments, accumulator and
      the schedule's count, as JAX's ``reset_opt_state`` does at a stage
      hand-off.
    """

    def __init__(self, params: Sequence[torch.Tensor], base_lr: float = 0.1,
                 weight_decay: float = 1e-6, warmup_steps: int = 1000, grad_accum: int = 1,
                 train_mask: Optional[Sequence[bool]] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.params = list(params)
        self.train_mask = (list(train_mask) if train_mask is not None
                           else [True] * len(self.params))
        if len(self.train_mask) != len(self.params):
            raise ValueError(f"{len(self.train_mask)} mask entries for {len(self.params)} "
                             "parameters")
        self.schedule = noam_warmup_schedule(base_lr, warmup_steps)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_accum = grad_accum
        self.reset()

    def reset(self) -> None:
        self.count = 0       # updates made (the adam and schedule counts)
        self.mini_step = 0   # micro-steps accumulated toward the next update
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if self.grad_accum > 1 else None

    def state_dict(self) -> Dict:
        """The moments ``mu`` and ``nu``, the accumulator ``acc``, ``count``
        and ``mini_step``, as references to the live tensors."""
        return {"grad_accum": self.grad_accum, "count": self.count,
                "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict()``'s state into this optimiser, bit for bit."""
        if state["grad_accum"] != self.grad_accum:
            raise ValueError(f"a state with grad_accum {state['grad_accum']} for an "
                             f"optimiser with grad_accum {self.grad_accum}")
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
        return float(self.schedule(self.count if count is None else count))

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """One micro-step. Returns True when it updated the parameters."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for g, p in zip(grads, self.params)]
        if self.acc is not None:
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            if self.mini_step < self.grad_accum - 1:
                self.mini_step += 1
                return False
            grads, self.acc = self.acc, [torch.zeros_like(p) for p in self.params]
            self.mini_step = 0
        idx = [i for i, keep in enumerate(self.train_mask) if keep]
        if idx:
            self._lamb([grads[i] for i in idx], [self.params[i] for i in idx],
                       [self.mu[i] for i in idx], [self.nu[i] for i in idx])
        self.count += 1
        return True

    def _lamb(self, grads, params, mu, nu) -> None:
        b1, b2 = self.b1, self.b2
        t = self.count + 1
        # scale_by_adam: (1 - b) g + b m, then the bias corrections
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        # the trust ratio, per tensor, on the device
        p_norm = list(torch._foreach_norm(params))
        u_norm = list(torch._foreach_norm(upd))
        _whole_tensor_norms(params, p_norm, u_norm)
        ratios = [torch.where((pn == 0) | (un == 0), 1.0, pn / un)
                  for pn, un in zip(p_norm, u_norm)]
        torch._foreach_mul_(upd, ratios)
        torch._foreach_mul_(upd, -float(self.schedule(self.count)))
        torch._foreach_add_(params, upd)
