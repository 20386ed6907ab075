"""Port parity of the v3 trainer loop against the JAX ``XVAPitchTrainer``.

Both trainers read the same cache directories (built once by the port on
the CPU), at the tiny config of tests/test_train_xvapitch.py. The JAX
trainer's construction compiles nothing, and no JAX program runs here: its
steps, its loss-seeding eval and its checkpoint writes are scripted or
patched on the test's instances (and the module attribute
``make_v3_loss_eval``, through ``monkeypatch``); nothing in the JAX package
changes. The port's steps are scripted the same way where the schedule is
compared, and real elsewhere.

- ``gam`` from the batcher's mean batch, as JAX takes it, and an optimiser
  update every ``gam`` micro-steps of the real step;
- the schedule: the items of every micro-step, their finetune/priors kind
  and freeze flag, the counters, the loss sorting, the stage, patience and
  deltas, ``graphs.json``, ``training.log`` and each checkpoint's host
  state equal JAX's, with a priors batcher and ``finetune_weight`` 3; a
  disc-loss sequence that moves both from stage 1 to 2 to 3;
- ``CheckpointManager``: the rolling window of 2, a bit-identical resume,
  an interrupted write that leaves the previous checkpoint newest, and the
  refusal of a directory holding only JAX orbax checkpoints (which JAX's
  manager lists while ignoring the port's files).

Scripted losses are exact float32 values, so every comparison is exact.
"""
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from xva_trainer_tpu.data import xva_dataset as jxd
from xva_trainer_tpu.data.dataset import Bucket as JaxBucket
from xva_trainer_tpu.data.text.xva_processor import XvaTextProcessor
from xva_trainer_tpu.models.xvapitch import XVAPitchConfig as JaxXVAPitchConfig
from xva_trainer_tpu.parallel.mesh import make_mesh
from xva_trainer_tpu.train import checkpoints as jax_checkpoints
from xva_trainer_tpu.train import xvapitch_trainer as jxt
from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.data.audio_io import save_wav
from xva_trainer_tpu_torch.data.dataset import Bucket
from xva_trainer_tpu_torch.data.text import v3_text_to_ids
from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
from xva_trainer_tpu_torch.train import checkpoints as port_checkpoints
from xva_trainer_tpu_torch.train import xvapitch_trainer as pxt

TINY_KW = dict(n_vocab=524, big=False, upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               spec_segment_size=8, mltts_rc=False, text_layers=2, posterior_layers=3,
               flow_wn_layers=2, num_flows=2, sdp_flows=2, pitch_layers=1)
TINY, JAX_TINY = XVAPitchConfig(**TINY_KW), JaxXVAPitchConfig(**TINY_KW)
BUCKETS = [Bucket(32, 64), Bucket(32, 128)]
# four clips in the 64-frame bucket (a batch of 4 at batch_size 2) and two in
# the 128-frame one (a batch of 2): a mean batch of 3
FT_ITEMS = [("f0", 0.55, "hello there"), ("f1", 0.6, "short one"),
            ("f2", 0.5, "a quick fox"), ("f3", 0.58, "rain falls"),
            ("f4", 1.0, "the longer clip of the set"), ("f5", 1.1, "another longer clip here")]
PRIOR_ITEMS = [("p0", 0.55, "prior voice one"), ("p1", 0.9, "prior voice two speaks"),
               ("p2", 0.6, "prior three"), ("p3", 1.05, "the fourth prior line")]


def _voiced(rng, seconds):
    n = int(seconds * 22050)
    t = np.arange(n) / 22050
    f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * 1.3 * t))
    ph = 2 * np.pi * np.cumsum(f0) / 22050
    y = sum(np.sin(k * ph) / k for k in range(1, 6))
    return np.clip(0.3 * y + 0.01 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _dataset(path, items, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "wavs"))
    for name, sec, _ in items:
        save_wav(os.path.join(path, "wavs", name + ".wav"), _voiced(rng, sec))
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(f"{n}.wav|{t}\n" for n, _, t in items))
    pxd.XvaFeatureCache(path, v3_text_to_ids("en"), device="cpu").build()
    return path


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    return (_dataset(str(root / "en_voice"), FT_ITEMS, 0),
            _dataset(str(root / "priors_voice"), PRIOR_ITEMS, 1))


DVEC = (np.random.default_rng(5).standard_normal(512) * 0.1).astype(np.float32)


def _batchers(caches, port: bool, priors=True, seed=3):
    if port:
        mk = lambda d: pxd.XvaFeatureCache(d, v3_text_to_ids("en"), device="cpu")  # noqa: E731
        bk, Batcher = BUCKETS, pxd.XvaBatcher
    else:
        mk = lambda d: jxd.XvaFeatureCache(d, XvaTextProcessor().text_to_sequence,  # noqa: E731
                                           use_pallas=True)
        bk, Batcher = [JaxBucket(b.text_len, b.mel_len) for b in BUCKETS], jxd.XvaBatcher
    ft = Batcher([mk(caches[0])], batch_size=2, d_vector=DVEC, buckets=bk, seed=seed)
    pr = Batcher([mk(caches[1])], batch_size=2, d_vector=DVEC, buckets=bk,
                 seed=seed + 1) if priors else None
    return ft, pr


def _token_ids(caches):
    """Each item's tokens → its loss-sorting key."""
    out = {}
    for d in caches:
        c = pxd.XvaFeatureCache(d, v3_text_to_ids("en"), device="cpu")
        for it in c.items:
            out[tuple(c.load_item(it)["tokens"].tolist())] = pxd.XvaBatcher.item_key(c, it)
    return out


def _item_loss(tokens, slens):
    """A per-item loss, the same whenever the item is seen (so that the
    loss table a resample reads does not depend on how far the prefetch
    thread ran ahead)."""
    tokens, slens = np.asarray(tokens), np.asarray(slens)
    return (tokens.sum(axis=1) * 1e-3 + slens * 1e-2).astype(np.float32)


class Script:
    """Scripted step results by micro-step k: the losses, the disc loss of
    ``disc(k)``, the per-sample losses of ``_item_loss``; records each
    micro-step's freeze flag and items."""

    def __init__(self, disc, token_ids):
        self.disc, self.token_ids = disc, token_ids
        self.calls = []

    def meta(self, freeze, tokens, slens):
        k = len(self.calls)
        rows = [tuple(np.trim_zeros(row, "b").tolist()) for row in np.asarray(tokens)]
        self.calls.append((freeze, [self.token_ids[r] for r in rows]))
        return {"loss": np.float32(10.0 + 0.125 * k), "loss_disc": np.float32(self.disc(k)),
                "loss_mel": np.float32(1.0), "loss_kl": np.float32(2.0),
                "loss_duration": np.float32(0.5),
                "per_sample_kl": _item_loss(tokens, slens),
                "per_sample_mel": np.zeros(len(rows), np.float32)}


def _run_jax(caches, out, cfg_kw, disc, max_steps, monkeypatch, priors=True):
    ft, pr = _batchers(caches, port=False, priors=priors)
    cfg = jxt.XvaTrainConfig(output_dir=out, batch_size=2, **cfg_kw)
    tr = jxt.XVAPitchTrainer(ft, cfg, JAX_TINY, mesh=make_mesh(n_data=1), priors_batcher=pr)
    script = Script(disc, _token_ids(caches))

    def step_for(freeze):
        def step(state, batch, rng):
            return state, script.meta(freeze, batch["tokens"], batch["slens"])
        return step

    tr._steps = {f: step_for(f) for f in (False, True)}
    tr.state = types.SimpleNamespace(g_params=None)  # no setup: no parameters are made
    saved = []
    tr.ckpt.save = lambda step, state, host=None, wait=False: saved.append(
        (step, json.loads(json.dumps(host))))  # a copy: the host lists grow later
    tr.meter.step = lambda: 1000.0
    monkeypatch.setattr(jxt, "make_v3_loss_eval", lambda model, use_amp=True: (
        lambda params, batch, rng: _item_loss(batch["tokens"], batch["slens"])))
    result = tr.train(max_steps=max_steps)
    return tr, script, saved, result


def _run_port(caches, out, cfg_kw, disc, max_steps, monkeypatch, priors=True):
    ft, pr = _batchers(caches, port=True, priors=priors)
    cfg = pxt.XvaTrainConfig(output_dir=out, batch_size=2, **cfg_kw)
    tr = pxt.XVAPitchTrainer(ft, cfg, TINY, priors_batcher=pr, device="cpu")
    script = Script(disc, _token_ids(caches))

    def step_for(freeze):
        def step(batch, generator):
            m = script.meta(freeze, batch["tokens"].numpy(), batch["slens"].numpy())
            return {k: torch.as_tensor(v) for k, v in m.items()}
        return step

    tr._steps = {f: step_for(f) for f in (False, True)}
    saved = []  # the writes are tested below; here only what each would hold
    tr.ckpt.save = lambda step, state, host=None: saved.append(
        (step, json.loads(json.dumps(host))))
    tr.meter.step = lambda: 1000.0
    monkeypatch.setattr(pxt, "make_v3_loss_eval", lambda model, use_amp=True: (
        lambda batch, generator: torch.from_numpy(_item_loss(batch["tokens"], batch["slens"]))))
    result = tr.train(max_steps=max_steps)
    return tr, script, saved, result


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _assert_same_schedule(j, p):
    (jt, js, jsaved, jres), (pt, ps, psaved, pres) = j, p
    assert ps.calls == js.calls and len(ps.calls) > 0
    for k in ("stage", "training_iters"):
        assert pres[k] == jres[k]
    for k in ("stage", "training_iters", "micro_steps", "finetune_counter", "finetune_it",
              "loss_sampling", "disc_loss_window", "disc_loss_per_ckpt", "deltas",
              "patience_count", "END_OF_TRAINING", "gam", "target_deltas"):
        assert getattr(pt, k) == getattr(jt, k), k
    assert psaved == jsaved
    assert json.loads(_read(pt.graphs.path)) == json.loads(_read(jt.graphs.path))
    assert _read(pt.logger.path) == _read(jt.logger.path)


def _disc_schedule(stage2_drop):
    """Disc loss by micro-step (gam = 2): down 2% an update for the first
    four updates (under stage 1's 4% target: stage 2 after the 4th
    checkpoint), then down ``stage2_drop`` an update."""
    def disc(k):
        u = k // 2
        return 2.0 * 0.98 ** min(u, 3) * (1.0 - stage2_drop) ** max(0, u - 3)
    return disc


def test_gam_from_the_mean_batch(caches, tmp_path):
    """The trainer takes JAX's gam, ceil(target_bs / the batcher's mean
    batch), not the config's ceil(target_bs / batch_size); both optimisers
    accumulate gam micro-steps; with the real step an update comes every gam
    micro-steps."""
    jft, _ = _batchers(caches, port=False, priors=False)
    pft, _ = _batchers(caches, port=True, priors=False)
    assert pft.mean_batch_size() == jft.mean_batch_size() == 3.0
    kw = dict(batch_size=2, target_bs=6, use_amp=False)
    jt = jxt.XVAPitchTrainer(jft, jxt.XvaTrainConfig(output_dir=str(tmp_path / "jax"), **kw),
                             JAX_TINY, mesh=make_mesh(n_data=1))
    cfg = pxt.XvaTrainConfig(output_dir=str(tmp_path / "port"), save_step=100,
                             seed_loss_sorting=False, **kw)
    pt = pxt.XVAPitchTrainer(pft, cfg, TINY, device="cpu")
    assert cfg.gam == 3 and jt.gam == pt.gam == 2
    assert pt.g_opt.grad_accum == pt.d_opt.grad_accum == 2
    counts = []
    for freeze, real in list(pt._steps.items()):
        def step(batch, gen, real=real):
            out = real(batch, gen)
            counts.append((pt.g_opt.count, pt.d_opt.count, pt.g_opt.mini_step))
            return out
        pt._steps[freeze] = step
    pt.train(max_steps=2)
    assert counts == [(0, 0, 1), (1, 1, 0), (1, 1, 1), (2, 2, 0)]
    assert pt.micro_steps == 4 and pt.training_iters == 2


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX trainer above writes nothing elsewhere
    return tmp_path


def test_schedule_equals_jax(caches, in_tmp, monkeypatch):
    """12 updates with a priors batcher and finetune_weight 3, stage 2 from
    the 4th checkpoint: the same items, finetune/priors order and freezes,
    counters, loss table, deltas, graphs.json, training.log and checkpoint
    host states as the JAX trainer."""
    kw = dict(target_bs=6, save_step=1, finetune_weight=3)
    disc = _disc_schedule(0.05)  # stage 2's drop (5%) above its target: no end
    j = _run_jax(caches, str(in_tmp / "jax"), kw, disc, 12, monkeypatch)
    p = _run_port(caches, str(in_tmp / "port"), kw, disc, 12, monkeypatch)
    _assert_same_schedule(j, p)
    pt, ps = p[0], p[1]
    assert pt.stage == 2 and pt.training_iters == 12 and pt.micro_steps == 24
    # the seeding pass keyed every finetune item; priors items never enter it
    assert sorted(pt.loss_sampling) == sorted(pxd.XvaBatcher.item_key(c, it)
                                              for c, it in pt.batcher._index)
    # stage 1 freezes every batch; stage 2 the priors batches only
    kinds = [(f, all("priors_voice" in n for n in names)) for f, names in ps.calls]
    assert all(f for f, _ in kinds[:8])
    assert all(f == priors for f, priors in kinds[8:])
    assert any(priors for _, priors in kinds[8:]) and not all(p for _, p in kinds[8:])


def test_early_stop_stages_equal_jax(caches, in_tmp, monkeypatch):
    """A disc loss that falls 2% an update, then 0.05%: both trainers move
    to stage 2 at the 4th checkpoint and stop (stage 3) at the 8th."""
    kw = dict(target_bs=6, save_step=1, finetune_weight=3)
    disc = _disc_schedule(0.0005)
    j = _run_jax(caches, str(in_tmp / "jax"), kw, disc, 50, monkeypatch)
    p = _run_port(caches, str(in_tmp / "port"), kw, disc, 50, monkeypatch)
    _assert_same_schedule(j, p)
    pt = p[0]
    assert pt.END_OF_TRAINING and pt.stage == 3 and pt.training_iters == 8
    assert [len(d) for d in pt.deltas] == [3, 3]
    log = _read(pt.logger.path)
    assert "Finished Stage 1. Moving on.." in log and "Finished Stage 2. Stopping training." in log


# ---------------- checkpoints ----------------


def _trainer(caches, out, **kw):
    ft, _ = _batchers(caches, port=True, priors=False)
    cfg = pxt.XvaTrainConfig(output_dir=out, batch_size=2, target_bs=3, save_step=1,
                             use_amp=False, **kw)
    return pxt.XVAPitchTrainer(ft, cfg, TINY, device="cpu")


def _host(tr):
    return {k: getattr(tr, k) for k in (
        "stage", "training_iters", "micro_steps", "finetune_counter", "finetune_it",
        "loss_sampling", "disc_loss_window", "disc_loss_per_ckpt", "deltas", "patience_count",
        "END_OF_TRAINING")}


def assert_state_identical(a, b):
    for ma, mb in ((a.model, b.model), (a.disc, b.disc)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        sa, sb = oa.state_dict(), ob.state_dict()
        for k in ("kind", "grad_accum", "count", "mini_step"):
            assert sa[k] == sb[k], k
        for k in ("mu", "nu", "acc"):
            assert (sa[k] is None) == (sb[k] is None), k
            if sa[k] is not None:
                assert all(torch.equal(x, y) for x, y in zip(sa[k], sb[k])), k
    assert _host(a) == _host(b)


def test_rolling_window_and_bit_identical_resume(caches, tmp_path):
    """Three real updates (gam = ceil(3 / a mean batch of 3) = 1) with a
    checkpoint after each: two files stay; a second trainer resumed
    from the output directory has the saver's parameters, optimiser state
    (moments, count, micro-step) and host state bit for bit, and trains on."""
    out = str(tmp_path / "out")
    tr = _trainer(caches, out)
    tr.setup(resume=False)
    tr.train(max_steps=3)
    files = sorted(f for f in os.listdir(out) if f.startswith("xVAPitch_"))
    assert files == ["xVAPitch_2.json", "xVAPitch_2.pt", "xVAPitch_3.json", "xVAPitch_3.pt"]
    side = json.loads(_read(os.path.join(out, "xVAPitch_3.json")))
    assert sorted(side) == ["deltas", "disc_loss_per_ckpt", "frames_s", "patience_count",
                            "stage", "training_iters"]
    assert tr.g_opt.count == 3 and len(tr.loss_sampling) == 6

    back = _trainer(caches, out)
    back.setup(resume=True)
    assert back.ckpt.latest_step() == 3
    assert_state_identical(tr, back)
    back.train(max_steps=4)
    assert back.training_iters == 4 and back.g_opt.count == 4
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == \
        ["xVAPitch_3.pt", "xVAPitch_4.pt"]


def test_interrupted_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    """A write cut short (the process dies inside ``torch.save``) leaves a
    temporary file only: the previous checkpoint stays newest and loads;
    the next save removes the leftover."""
    mgr = port_checkpoints.CheckpointManager(str(tmp_path), prefix="xVAPitch")
    state = {"w": torch.arange(6.0), "trainer": {"micro_steps": 4}}
    mgr.save(1, state, {"stage": 1})
    mgr.save(2, {**state, "w": state["w"] + 1}, {"stage": 2})

    def dies(obj, f, *a, **k):
        f.write(b"PK\x03\x04 partial")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(port_checkpoints.torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(3, {**state, "w": state["w"] + 2}, {"stage": 3})
    monkeypatch.undo()
    assert os.path.exists(tmp_path / "xVAPitch_3.pt.tmp")
    assert not os.path.exists(tmp_path / "xVAPitch_3.pt")
    assert not os.path.exists(tmp_path / "xVAPitch_3.json")
    again = port_checkpoints.CheckpointManager(str(tmp_path), prefix="xVAPitch")
    step, got, host = again.restore_latest()
    assert step == 2 and host == {"stage": 2} and torch.equal(got["w"], state["w"] + 1)
    again.save(4, state, {"stage": 4})
    assert sorted(os.listdir(tmp_path)) == ["xVAPitch_2.json", "xVAPitch_2.pt",
                                            "xVAPitch_4.json", "xVAPitch_4.pt"]


def test_jax_orbax_checkpoints_refused(caches, tmp_path):
    """An output directory holding a JAX orbax checkpoint and none of the
    port's: ``setup(resume=True)`` raises instead of starting from scratch.
    Each package's manager ignores the other's checkpoints."""
    out = str(tmp_path / "out")
    jmgr = jax_checkpoints.CheckpointManager(out, prefix="xVAPitch")
    jmgr.save(5, {"w": jax.numpy.ones(3)}, {"stage": 1, "training_iters": 5}, wait=True)
    assert os.path.isdir(os.path.join(out, "xVAPitch_5"))
    tr = _trainer(caches, out)
    assert tr.ckpt.latest_step() is None and tr.ckpt.foreign_steps() == [5]
    with pytest.raises(RuntimeError, match="JAX orbax checkpoints"):
        tr.setup(resume=True)
    tr.setup(resume=False)  # a fresh start, asked for
    tr.ckpt.save(7, {"w": torch.ones(2)}, {"stage": 1})
    assert jmgr.latest_step() == 5 and tr.ckpt.latest_step() == 7
    # the port's window never touches the JAX directory
    for s in (8, 9):
        tr.ckpt.save(s, {"w": torch.ones(2)}, {"stage": 1})
    assert os.path.isdir(os.path.join(out, "xVAPitch_5")) and tr.ckpt._steps() == [8, 9]


def test_output_samples_count_lengths_and_language(caches, tmp_path):
    """Previews: one wav a sentence in ``viz/<updates>/``, each
    ``y_lengths · hop`` samples, tokens padded to 128, and the language of
    the finetune set's first cache (here German), as the JAX trainer
    chooses it. The draws are the port's own (no parity in noise)."""
    from xva_trainer_tpu_torch.data.audio_io import load_wav
    from xva_trainer_tpu_torch.data.xva_dataset import lang_to_id

    de = pxd.XvaFeatureCache(caches[0], v3_text_to_ids("en"), lang="de", device="cpu")
    batcher = pxd.XvaBatcher([de], batch_size=2, d_vector=DVEC, buckets=BUCKETS)
    tr = pxt.XVAPitchTrainer(batcher, pxt.XvaTrainConfig(output_dir=str(tmp_path), batch_size=2),
                             TINY, device="cpu")
    calls, real_infer = [], tr.model.infer

    def infer(tokens, dvec, lang, **kw):
        out = real_infer(tokens, dvec, lang, **kw)
        calls.append((tokens.shape, int(lang[0]), int(out["y_lengths"][0]), kw["max_frames"]))
        return out

    tr.model.infer = infer
    paths = tr.output_samples(["Hello there.", "A second, longer preview sentence."], DVEC,
                              max_frames=64)
    assert paths == [str(tmp_path / "viz" / "0" / f"sample_{i}.wav") for i in range(2)]
    assert [c[0] for c in calls] == [(1, 128)] * 2 and {c[3] for c in calls} == {64}
    assert {c[1] for c in calls} == {lang_to_id("de")} != {lang_to_id("en")}
    for p, c in zip(paths, calls):
        y, sr = load_wav(p)
        assert sr == 22050 and len(y) == c[2] * TINY.hop_length > 0 and np.isfinite(y).all()
    assert tr.model.training  # the preview's eval mode is undone
