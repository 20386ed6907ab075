"""Port parity of the GAN optimisers against ``optax``, through the JAX
package's ``make_gan_optimizer``: AdamW and Lion, the lr·γ^(t // decay_every)
schedule, and ``optax.MultiSteps`` accumulation (gam = 3), for 7 steps on a
small parameter tree, within 1e-6. A parameter without a gradient counts as
zeros (it still decays); a masked update leaves the parameter as it is while
its moments advance, as the JAX step's freeze does."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xva_trainer_tpu.train.optim import make_gan_optimizer as jax_make_gan_optimizer
from xva_trainer_tpu_torch.train.optim import GanOptimizer

SHAPES = {"w": (4, 3), "b": (3,), "g": (5, 1, 2), "unused": (2, 2)}
STEPS = 7


def _run(kind, grad_accum, mask=None, decay_every=2):
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (np.zeros(s, np.float32) if k == "unused"
                  else rng.standard_normal(s).astype(np.float32)) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    kw = dict(gamma=0.5, decay_every=decay_every, grad_accum=grad_accum, kind=kind)

    tx = jax_make_gan_optimizer(1e-2, **kw)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    ref = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        if mask is not None:
            upd = {k: (v if mask[k] else jnp.zeros_like(v)) for k, v in upd.items()}
        params = optax.apply_updates(params, upd)
        ref.append({k: np.asarray(v) for k, v in params.items()})

    tparams = [torch.from_numpy(init[k].copy()) for k in SHAPES]
    opt = GanOptimizer(tparams, 1e-2, **kw)
    ours = []
    for g in grads:
        tg = [None if k == "unused" else torch.from_numpy(g[k]) for k in SHAPES]
        opt.step(tg, None if mask is None else [mask[k] for k in SHAPES])
        ours.append({k: p.numpy().copy() for k, p in zip(SHAPES, tparams)})
    return ref, ours, opt


@pytest.mark.parametrize("grad_accum", [1, 3])
@pytest.mark.parametrize("kind", ["adamw", "lion"])
def test_matches_optax(kind, grad_accum):
    ref, ours, opt = _run(kind, grad_accum)
    for r, o in zip(ref, ours):
        for k in SHAPES:
            assert np.abs(o[k] - r[k]).max() < 1e-6, k
    # updates happen every grad_accum calls; the unused parameter decays
    assert opt.count == STEPS // grad_accum
    assert not np.array_equal(ours[-1]["unused"], ours[0]["unused"])
    moved = [not np.array_equal(ours[i]["w"], ours[i - 1]["w"]) for i in range(1, STEPS)]
    assert moved == [(i + 1) % grad_accum == 0 for i in range(1, STEPS)]


def test_schedule_and_lion_scaling():
    opt = GanOptimizer([torch.zeros(2)], 1e-2, gamma=0.5, decay_every=2, kind="lion")
    assert opt.lr == pytest.approx(2e-3) and opt.weight_decay == pytest.approx(0.05)
    assert [opt.learning_rate(t) for t in range(5)] == pytest.approx(
        [2e-3, 2e-3, 1e-3, 1e-3, 5e-4])
    with pytest.raises(ValueError, match="optimizer kind"):
        GanOptimizer([torch.zeros(2)], 1e-2, kind="sgd")


def test_masked_updates_keep_moments_moving():
    """The freeze: masked parameters do not move (no weight decay either),
    the others match optax with the same updates zeroed."""
    mask = {"w": True, "b": False, "g": True, "unused": False}
    ref, ours, opt = _run("adamw", 1, mask=mask)
    for r, o in zip(ref, ours):
        for k in SHAPES:
            assert np.abs(o[k] - r[k]).max() < 1e-6, k
    assert np.array_equal(ours[-1]["b"], ours[0]["b"])
    assert opt.mu[1].abs().sum() > 0  # the masked parameter's moments advanced


@pytest.mark.parametrize("grad_accum", [1, 3])
@pytest.mark.parametrize("kind", ["adamw", "lion"])
def test_state_dict_round_trip(kind, grad_accum, tmp_path):
    """An optimiser saved mid-accumulation (``torch.save`` of
    ``state_dict()``) and loaded into a fresh one on copies of the
    parameters makes the same next updates, bit for bit."""
    rng = np.random.default_rng(1)
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
              SHAPES.values()] for _ in range(5)]
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES.values()]
    kw = dict(gamma=0.5, grad_accum=grad_accum, kind=kind)
    opt = GanOptimizer(params, 1e-2, **kw)
    for g in grads[:4]:  # 4 = one update and one micro-step at grad_accum 3
        opt.step(g)
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    copies = [p.clone() for p in params]
    back = GanOptimizer(copies, 1e-2, **kw)
    back.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert (back.count, back.mini_step) == (opt.count, opt.mini_step)
    for g in grads[4:] + grads[:3]:
        opt.step(g)
        back.step(g)
        assert all(torch.equal(a, b) for a, b in zip(params, copies))
    with pytest.raises(ValueError, match="grad_accum"):
        GanOptimizer(copies, 1e-2, gamma=0.5, grad_accum=grad_accum + 1,
                     kind=kind).load_state_dict(opt.state_dict())


@pytest.mark.parametrize("freezes", [(False, True), (True, False), (True, True)])
def test_freeze_at_the_boundary_matches_jax(freezes):
    """The two v3 steps share one pair of optimisers. A frozen micro-step
    zeroes the frozen modules' gradients before they are accumulated, and a
    freeze at the micro-step that completes an update masks that whole
    update for them, as the JAX step's ``_zero_module_grads`` and
    ``_zero_module_updates`` around ``optax.MultiSteps`` do (gam = 2; 2
    updates)."""
    from xva_trainer_tpu.train.xvapitch_trainer import _zero_module_grads, _zero_module_updates
    from xva_trainer_tpu_torch.train.xvapitch_trainer import zero_module_grads

    tree = {"posterior_encoder": (3, 2), "text_encoder": (4,), "waveform_decoder": (2, 2)}
    rng = np.random.default_rng(2)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in tree.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in tree.items()}
             for _ in range(4)]
    frozen = [k in ("posterior_encoder", "waveform_decoder") for k in tree]

    tx = jax_make_gan_optimizer(1e-2, grad_accum=2)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    tparams = [torch.from_numpy(init[k].copy()) for k in tree]
    opt = GanOptimizer(tparams, 1e-2, grad_accum=2)
    for i, g in enumerate(grads):
        freeze = freezes[i % 2]
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if freeze:
            jg = _zero_module_grads(jg)
        upd, state = tx.update(jg, state, params)
        if freeze:
            upd = _zero_module_updates(upd)
        params = optax.apply_updates(params, upd)

        tg = [torch.from_numpy(g[k]) for k in tree]
        if freeze:
            tg = zero_module_grads(tg, frozen)
        opt.step(tg, [not f for f in frozen] if freeze else None)
        for k, p in zip(tree, tparams):
            assert np.abs(p.numpy() - np.asarray(params[k])).max() < 1e-6, (i, k)
    moved = {k: not np.array_equal(p.numpy(), init[k]) for k, p in zip(tree, tparams)}
    assert moved["text_encoder"]
    assert moved["posterior_encoder"] == (not freezes[1])  # the boundary's flag decides
