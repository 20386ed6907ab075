"""Data parallelism in the port's steps: the v3 step and FastPitch's stage-4
step on two gloo ranks, each with its slice of a global batch of 4, against
the port's one-process step on the whole batch and against the JAX step on
that batch under a 2-way data mesh, weights carried across.

- The v3 step (fp32, SGD at 1e-4, two micro-steps): dropout off and the JAX step's
  draws fed in (the posterior's noise, the SDP's and the segment starts,
  recovered as ``tests/test_torch_train_step.py`` recovers them; the JAX
  step is run twice with the same key, so both micro-steps take the same
  draws). The slices have unequal lengths, so that a loss normalised by
  its rank's own frames would miss: the test shows that the mean of the
  two halves' losses misses the global loss by more than the bar. Bars:
  the losses of the two ranks within 1e-5 relative of the one-process
  step's and 1e-4 of JAX's; both ranks' parameters identical; every
  parameter's update within ``assert_updates_match``'s bar of the
  one-process step's and of the port's one-process step in float64
  (``run_v3_f64``), and within 1e-2 in L2 of JAX's fp32 step (see
  ``assert_updates_close_l2``): on this batch JAX's fp32 step is the one
  that misses the float64 step, whose JAX twin
  ``scripts/probe_v3_dp_f64.py`` runs.
- The v3 step with every draw (dropout masks included) from the step's
  generator, in training mode: two ranks against one process, as above.
- A non-finite loss on one rank only: both ranks skip the update together.
- FastPitch's stage 4 (LAMB, two micro-steps of one update): losses within
  1e-5 relative, parameters within 1e-5 of their max abs (the bars of
  ``tests/test_torch_fastpitch_train.py``) of the one-process step and of
  JAX's.
"""
import copy
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_dist_common import run_fastpitch, run_ranks, run_v3, run_v3_f64
from torch_v3_common import (HOP, JCFG, KEY, TCFG, UNUSED, assert_updates_match, deterministic,
                             draws_of, fastpitch_configs, jax_forward, seeded_fastpitch,
                             seeded_params)

from xva_trainer_tpu.models.fastpitch import FastPitch as JaxFastPitch
from xva_trainer_tpu.models.xvapitch import VitsDiscriminator as JaxVitsDiscriminator
from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from xva_trainer_tpu.parallel.mesh import shard_batch as jax_shard_batch
from xva_trainer_tpu.train import fastpitch_trainer as jft
from xva_trainer_tpu.train import optim as jax_optim
from xva_trainer_tpu.train.xvapitch_trainer import V3State
from xva_trainer_tpu.train.xvapitch_trainer import make_v3_step as jax_make_v3_step
from xva_trainer_tpu_torch.interop.convert import (fastpitch_state_dict, train_state_dicts,
                                                   vits_disc_state_dict, xvapitch_state_dict)

W, GB, T_TEXT, T_SPEC = 2, 4, 24, 64
V3_LOSSES = ("loss", "loss_disc", "loss_mel", "loss_kl", "loss_duration", "loss_pitch",
             "loss_gen", "loss_feat")
JFP, FP = fastpitch_configs()
FP_TEXT, FP_MEL, FP_K, FP_WARMUP = 12, 40, 2, 50
# SGD's rate for the two v3 micro-steps: at the step tests' 1e-3 the seeded
# model's KL grows from 3.6e3 to 4.6e3 in one step, and the second step
# magnifies fp32 noise (a thread count's worth) past the bars
DP_LR = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def v3_batch(seed=0):
    """A global v3 batch of 4 whose halves differ in length: 120 and 84
    frames, 44 and 28 tokens."""
    rng = np.random.default_rng(seed)
    t = np.arange(T_SPEC * HOP) / 22050
    wav = np.stack([0.4 * np.sin(2 * np.pi * (140 + 50 * i) * t) for i in range(GB)])
    wav = wav + 0.02 * rng.standard_normal(wav.shape)
    pitch = rng.standard_normal((GB, 1, T_SPEC)).astype(np.float32)
    pitch[rng.random(pitch.shape) < 0.3] = 0.0
    return {
        "tokens": rng.integers(1, 500, (GB, T_TEXT)).astype(np.int32),
        "tlens": np.array([24, 20, 12, 16], np.int32),
        "slens": np.array([64, 56, 40, 44], np.int32),
        "pitch": pitch,
        "energy": rng.standard_normal((GB, T_SPEC)).astype(np.float32),
        "wav": np.round(np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[..., None],
        "dvec": (rng.standard_normal((GB, 512)) * 0.1).astype(np.float32),
        "lang": np.array([5, 2, 7, 1], np.int32),
    }


def fastpitch_batches(seed=3):
    """FP_K global FastPitch batches of 4 (fp16 features), the second half's
    items shorter than the first's."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FP_K):
        in_lens = np.array([12, 10, 6, 5], np.int32)
        mel_lens = np.array([40, 36, 22, 18], np.int32)
        b = dict(tokens=np.zeros((GB, FP_TEXT), np.int32), in_lens=in_lens,
                 mel=np.zeros((GB, FP_MEL, 80), np.float32),
                 mel_lens=mel_lens, pitch=np.zeros((GB, 1, FP_MEL), np.float32),
                 energy=np.zeros((GB, FP_MEL), np.float32))
        for i in range(GB):
            b["tokens"][i, :in_lens[i]] = rng.integers(1, 148, in_lens[i])
            b["mel"][i, :mel_lens[i]] = rng.standard_normal((mel_lens[i], 80)) - 4.0
            b["pitch"][i, 0, :mel_lens[i]] = rng.standard_normal(mel_lens[i])
            b["energy"][i, :mel_lens[i]] = np.abs(rng.standard_normal(mel_lens[i])) * 20
        for k in ("mel", "pitch", "energy"):
            b[k] = b[k].astype(np.float16)
        out.append(b)
    return out


def jax_v3_mesh_steps(g_params, d_params, b, n_steps=2):
    """JAX's make_v3_step (SGD, dropout off) under a 2-way data mesh,
    ``n_steps`` times with the step key KEY. Returns the last meta and the
    parameters after, in the port's layout."""
    model, disc = JaxXVAPitch(JCFG), JaxVitsDiscriminator()
    g_tx, d_tx = optax.sgd(DP_LR), optax.sgd(DP_LR)
    step = jax_make_v3_step(model, disc, g_tx, d_tx, freeze_post_dec=False, use_amp=False)
    gp, dp = (jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(p)) for p in (g_params, d_params))
    state = V3State(g_params=gp, d_params=dp, g_opt=g_tx.init(gp), d_opt=d_tx.init(dp),
                    step=jnp.zeros((), jnp.int32))
    mesh = jax_make_mesh(n_data=W)
    with mesh, nn.intercept_methods(deterministic):
        dev = jax_shard_batch(mesh, b)
        for _ in range(n_steps):
            state, meta = step(state, dev, KEY)
    new = (xvapitch_state_dict(jax.device_get(state.g_params), TCFG),
           vits_disc_state_dict(jax.device_get(state.d_params)))
    return {k: np.asarray(v) for k, v in meta.items()}, new


def jax_fastpitch_mesh_steps(params, batches):
    model = JaxFastPitch(JFP)
    tx = jax_optim.make_fastpitch_optimizer(0.1, 1e-6, FP_WARMUP, grad_accum=FP_K,
                                            freeze_mask=jax_optim.fastpitch_stage_mask(4))
    step = jft.make_stage_step(model, 4, tx, use_amp=False, device_prior=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jft.TrainState(params=jp, opt_state=tx.init(jp), step=jnp.zeros((), jnp.int32))
    mesh = jax_make_mesh(n_data=W)
    metas = []
    with mesh:
        for i, b in enumerate(batches):
            state, meta = step(state, jax_shard_batch(mesh, b), jnp.asarray(0.0),
                               jax.random.PRNGKey(i))
            metas.append({k: np.asarray(v) for k, v in meta.items()})
    return metas, fastpitch_state_dict(jax.tree_util.tree_map(np.asarray, state.params), FP)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs, its one-process run, its two-rank run (one
    spawn for all), and the JAX mesh runs."""
    torch.set_num_threads(1)  # as the ranks run
    g_params, d_params = seeded_params(0)
    b = v3_batch()
    out, _, sdp_noise = jax_forward(g_params, d_params, b)
    draws = draws_of(out, b, sdp_noise)
    g_sd, d_sd = train_state_dicts(g_params, d_params, TCFG)
    base = dict(cfg=dataclasses.asdict(TCFG), g_sd=g_sd, d_sd=d_sd, lr=DP_LR, seed=11)
    bad = copy.deepcopy(b)
    bad["dvec"][3] = np.nan  # rank 1's second item
    v3_cases = {
        "jax_draws": dict(base, train_mode=False, batches=[b, b], draws=[draws, draws]),
        "generator": dict(base, train_mode=True, batches=[b, b], draws=[None, None]),
        "nonfinite": dict(base, train_mode=False, batches=[bad], draws=[draws]),
    }
    fp_params = seeded_fastpitch(JFP, seed=2, t_text=FP_TEXT, t_mel=FP_MEL)
    fp_batches = fastpitch_batches()
    fp_case = dict(cfg=dataclasses.asdict(FP), sd=fastpitch_state_dict(fp_params, FP), stage=4,
                   warmup=FP_WARMUP, seed=4, batches=fp_batches)
    ranks = run_ranks("dp", W, tmp_path_factory.mktemp("dp"),
                      {"v3": v3_cases, "fastpitch": fp_case})
    return {
        "v3": v3_cases, "fp": fp_case, "ranks": ranks, "b": b, "draws": draws,
        "g_params": g_params, "d_params": d_params, "fp_params": fp_params,
        "one": {name: run_v3(c) for name, c in v3_cases.items()},
        "f64": run_v3_f64(v3_cases["jax_draws"]),
        "fp_one": run_fastpitch(fp_case),
    }


def assert_updates_close_l2(old, new, ref_new):
    """Each tensor's update within 1e-2 of JAX's in the L2 norm, plus the
    float noise of ``assert_updates_match`` (1e-6 of the model's largest
    update and 2 ulp of the tensor's largest value, per element). JAX's
    fp32 step misses its own float64 step on this batch by up to 2.7 bars
    of ``assert_updates_match`` on the decoder at one micro-step and 8.1
    at two, where the port's fp32 step stays within 0.2 bars of both
    float64 steps (``scripts/probe_v3_dp_f64.py``); the ranks are held to
    the port's float64 step at the max-abs bar instead."""
    refs = {k: ref_new[k] - old[k] for k in ref_new if k in new and k not in UNUSED}
    floor = 1e-6 * max(float(r.abs().max()) for r in refs.values())
    for k, ref in refs.items():
        ulp2 = 2 * np.finfo(np.float32).eps * float(old[k].abs().max())
        err = float((new[k] - old[k] - ref).norm())
        assert err <= 1e-2 * float(ref.norm()) + (floor + ulp2) * ref.numel() ** 0.5, k


def _assert_ranks_equal(ranks, name):
    a, b = ranks[0]["v3"][name], ranks[1]["v3"][name]
    for which in ("g", "d"):
        assert all(torch.equal(a[which][k], b[which][k]) for k in a[which]), which


def _assert_v3_matches_one_process(runs, name):
    case, one = runs["v3"][name], runs["one"][name]
    ranks = [r["v3"][name] for r in runs["ranks"]]
    for r in ranks:
        for m_r, m_one in zip(r["metas"], one["metas"]):
            for k in V3_LOSSES:
                assert rel(m_r[k], m_one[k]) < 1e-5, (name, k, m_r[k], m_one[k])
    old = (case["g_sd"], case["d_sd"])
    for i, which in enumerate(("g", "d")):
        assert_updates_match(old[i], ranks[0][which], old[i], one[which])
    _assert_ranks_equal(runs["ranks"], name)


def test_v3_local_normalisers_would_miss(runs):
    """Each rank normalising by its own frames and the gradients averaged
    (the mean of the two halves' one-process updates, with SGD) misses the
    global batch's update beyond the bar that the two ranks meet: the
    matches below rest on the global normalisers."""
    case = runs["v3"]["jax_draws"]

    def one_step(rows):
        return run_v3(dict(case, batches=[{k: v[rows] for k, v in runs["b"].items()}],
                           draws=[{k: v[rows] for k, v in runs["draws"].items()}]))

    halves = [one_step(slice(0, 2)), one_step(slice(2, 4))]
    whole = one_step(slice(0, 4))
    old = case["g_sd"]
    averaged = {k: (halves[0]["g"][k] + halves[1]["g"][k]) / 2 for k in old}
    with pytest.raises(AssertionError):
        assert_updates_match(old, averaged, old, whole["g"])


def test_v3_two_ranks_match_one_process_and_jax(runs):
    _assert_v3_matches_one_process(runs, "jax_draws")
    j_meta, j_new = jax_v3_mesh_steps(runs["g_params"], runs["d_params"], runs["b"])
    case = runs["v3"]["jax_draws"]
    for r in runs["ranks"]:
        last = r["v3"]["jax_draws"]["metas"][-1]
        for k in V3_LOSSES:
            assert rel(last[k], j_meta[k]) < 1e-4, (k, last[k], j_meta[k])
    ours = runs["ranks"][0]["v3"]["jax_draws"]
    f64 = {k: {n: v.float() for n, v in runs["f64"][k].items()} for k in ("g", "d")}
    for i, which in enumerate(("g", "d")):
        old = (case["g_sd"], case["d_sd"])[i]
        assert_updates_match(old, ours[which], old, f64[which])
        assert_updates_close_l2(old, ours[which], j_new[i])


def test_v3_two_ranks_draw_from_the_generator(runs):
    """Dropout on, and every draw from the step's generator: each rank draws
    for the global batch and keeps its rows."""
    _assert_v3_matches_one_process(runs, "generator")
    m = runs["ranks"][0]["v3"]["generator"]["metas"]
    assert m[0]["loss"] != m[1]["loss"]  # the second micro-step saw the update


def test_v3_nonfinite_on_one_rank_skips_on_both(runs):
    case = runs["v3"]["nonfinite"]
    for r in runs["ranks"]:
        res = r["v3"]["nonfinite"]
        assert not np.isfinite(res["metas"][0]["loss"])
        for which, old in (("g", case["g_sd"]), ("d", case["d_sd"])):
            assert all(torch.equal(res[which][k], old[k]) for k in old), which
    one = runs["one"]["nonfinite"]
    assert not np.isfinite(one["metas"][0]["loss"])
    _assert_ranks_equal(runs["ranks"], "nonfinite")


def test_fastpitch_stage4_two_ranks_match_one_process_and_jax(runs):
    one = runs["fp_one"]
    j_metas, j_params = jax_fastpitch_mesh_steps(runs["fp_params"], runs["fp"]["batches"])
    for r in runs["ranks"]:
        res = r["fastpitch"]
        for m_r, m_one, m_j in zip(res["metas"], one["metas"], j_metas):
            for k in m_j:
                assert rel(m_r[k], m_one[k]) <= 1e-5, (k, m_r[k], m_one[k])
                assert rel(m_r[k], m_j[k]) <= 1e-5, (k, m_r[k], m_j[k])
        for k, v in res["params"].items():
            assert rel(v, one["params"][k]) <= 1e-5, k
            assert rel(v, j_params[k]) <= 1e-5, k
    before = runs["fp"]["sd"]
    moved = [k for k, v in one["params"].items() if not torch.equal(v, before[k])]
    assert any("decoder" in k for k in moved)
