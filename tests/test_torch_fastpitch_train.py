"""Port parity of the v2 FastPitch trainer, its optimiser, its export and
the v2 inference against the JAX package, on the CPU.

- Each stage's step: k = 3 micro-steps at ``grad_accum`` 3 (one LAMB
  update), JAX's ``make_stage_step`` with optax's LAMB, freeze mask and
  ``MultiSteps`` against the port's, from the same seeded parameters, on the
  same batches (fp16 features, an all-zero padded row, the prior made from
  the lengths): every micro-step's losses within 1e-5 relative, every
  parameter after the update within 1e-5 of its max abs, the stage's frozen
  tensors bit-identical on both sides. The warm-up is 50 updates, so the
  first update moves a parameter by about 3e-4 of its size: a step that
  left the stage-1 encoder's attention and FF layers in place (their
  gradient is zero, and optax still decays them through the trust ratio)
  misses the bar by 30 times.
- ``reset_opt_state`` at a stage hand-off, ``extract_durations`` files,
  ``finish_epoch``'s stage advances and early-stop state on a scripted loss
  sequence, a checkpoint and resume round trip, the refusal of a JAX orbax
  directory.
- ``export_fastpitch_v2`` against JAX's (the key set, values within 1 fp16
  ulp, the JSON), read back by JAX's ``load_fastpitch_checkpoint``; the warm
  start from a ``.pt`` JAX's export wrote (both at the reference's depths,
  narrow: JAX's loader reads the 6 + 6-layer key set).
- ``V2InferenceModel.tts`` against JAX's (mel 1e-4, ``dec_lens`` equal, wav
  1e-4), and ``istft`` and ``griffin_lim`` from the same initial phases.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_v3_common import _seeded, fastpitch_configs, port_fastpitch, seeded_fastpitch

from xva_trainer_tpu.interop import fastpitch_map as jax_map
from xva_trainer_tpu.models.fastpitch import FastPitch as JaxFastPitch
from xva_trainer_tpu.models.fastpitch import FastPitchConfig as JaxFastPitchConfig
from xva_trainer_tpu.models.hifigan import Generator as JaxGenerator
from xva_trainer_tpu.models.hifigan import HifiganConfig as JaxHifiganConfig
from xva_trainer_tpu.ops import griffin_lim as jgl
from xva_trainer_tpu.train import checkpoints as jax_ckpt
from xva_trainer_tpu.train import fastpitch_trainer as jft
from xva_trainer_tpu.train import optim as jax_optim
from xva_trainer_tpu.train import pipeline as jax_pipeline
from xva_trainer_tpu.train.early_stop import EarlyStopState as JaxEarlyStop
from xva_trainer_tpu_torch.interop.convert import hifigan_v2_state_dict
from xva_trainer_tpu_torch.interop.fastpitch_map import load_fastpitch_checkpoint
from xva_trainer_tpu_torch.models.fastpitch import FastPitchConfig
from xva_trainer_tpu_torch.models.hifigan.models import Generator, HifiganConfig
from xva_trainer_tpu_torch.ops import griffin_lim as pgl
from xva_trainer_tpu_torch.train import fastpitch_trainer as pft
from xva_trainer_tpu_torch.train import pipeline
from xva_trainer_tpu_torch.train.checkpoints import export_fastpitch_v2
from xva_trainer_tpu_torch.train.early_stop import EarlyStopState
from xva_trainer_tpu_torch.train.optim import (_STAGE_FROZEN_MODULES, LambOptimizer,
                                               fastpitch_stage_mask)

JCFG, CFG = fastpitch_configs()
DEEP_KW = dict(symbols_embedding_dim=32, in_fft_d_head=16, out_fft_d_head=16,
               in_fft_filter_size=64, out_fft_filter_size=64, predictor_filter_size=32)
JDEEP, DEEP = JaxFastPitchConfig(**DEEP_KW), FastPitchConfig(**DEEP_KW)
GEN_KW = dict(resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_initial_channel=32)
B, T_TEXT, T_MEL, K = 3, 12, 40, 3
WARMUP = 50


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def rel_err(ours, ref) -> float:
    ours = ours.detach().double().numpy() if torch.is_tensor(ours) else np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def micro_batches(seed=0):
    """K collated-like batches (numpy): fp16 features, one all-zero padded
    row in the last, ``durs`` summing to each item's frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(K):
        in_lens = rng.integers(4, T_TEXT + 1, B).astype(np.int32)
        mel_lens = rng.integers(T_MEL // 2, T_MEL + 1, B).astype(np.int32)
        in_lens[0], mel_lens[0] = T_TEXT, T_MEL
        n_real = B - 1 if i == K - 1 else B
        tokens = np.zeros((B, T_TEXT), np.int32)
        mel = np.zeros((B, T_MEL, 80), np.float32)
        pitch = np.zeros((B, 1, T_MEL), np.float32)
        energy = np.zeros((B, T_MEL), np.float32)
        durs = np.zeros((B, T_TEXT), np.float32)
        for b in range(n_real):
            tokens[b, :in_lens[b]] = rng.integers(1, 148, in_lens[b])
            mel[b, :mel_lens[b]] = rng.standard_normal((mel_lens[b], 80)) - 4.0
            p = rng.standard_normal(mel_lens[b])
            p[rng.random(mel_lens[b]) < 0.3] = 0.0
            pitch[b, 0, :mel_lens[b]] = p
            energy[b, :mel_lens[b]] = np.abs(rng.standard_normal(mel_lens[b])) * 20
            cuts = np.sort(rng.choice(np.arange(1, mel_lens[b]), in_lens[b] - 1, replace=False))
            durs[b, :in_lens[b]] = np.diff(np.concatenate([[0], cuts, [mel_lens[b]]]))
        if n_real < B:
            in_lens[n_real:], mel_lens[n_real:] = 1, 1
        out.append(dict(tokens=tokens, in_lens=in_lens, mel=mel.astype(np.float16),
                        mel_lens=mel_lens, pitch=pitch.astype(np.float16),
                        energy=energy.astype(np.float16), durs=durs))
    return out


def _torch_batch(b):
    out = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
           for k, v in b.items()}
    if "mel_lens" in b:
        out["all_aligned"] = bool(np.all(b["mel_lens"] >= b["in_lens"]))
    return out


def _flat(params):
    """{torch-style name: array} of a JAX tree through the port's carry."""
    from xva_trainer_tpu_torch.interop.convert import fastpitch_state_dict

    return {k: v.numpy() for k, v in fastpitch_state_dict(params, CFG).items()}


# stage: whether it reads the extracted durations (stages 2 and 3) or runs
# the aligner and MAS (stages 1 and 4)
STAGES = [(1, False), (2, True), (3, True), (4, False)]


@pytest.mark.parametrize("stage,use_gt", STAGES, ids=[f"stage{s}" for s, _ in STAGES])
def test_stage_step_matches_jax(stage, use_gt):
    params = seeded_fastpitch(JCFG, seed=2, t_text=T_TEXT, t_mel=T_MEL)
    model = JaxFastPitch(JCFG)
    tx = jax_optim.make_fastpitch_optimizer(0.1, 1e-6, WARMUP, grad_accum=K,
                                            freeze_mask=jax_optim.fastpitch_stage_mask(stage))
    jstep = jft.make_stage_step(model, stage, tx, use_gt_durs=use_gt, use_amp=False,
                                device_prior=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jft.TrainState(params=jparams, opt_state=tx.init(jparams),
                           step=jnp.zeros((), jnp.int32))

    port = port_fastpitch(params, CFG).train()  # dropout is 0: train mode changes nothing
    opt = LambOptimizer(port.parameters(), 0.1, 1e-6, WARMUP, grad_accum=K,
                        train_mask=fastpitch_stage_mask(port, stage))
    pstep = pft.make_stage_step(port, stage, opt, use_gt_durs=use_gt, use_amp=False,
                                device_prior=True)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    keys = pft.batch_keys_for(stage, use_gt, True)
    kl = 0.3 if stage == 1 else 0.0
    for i, b in enumerate(micro_batches()):
        sel = {k: v for k, v in b.items() if k in keys}
        state, jmeta = jstep(state, {k: jnp.asarray(v) for k, v in sel.items()},
                             jnp.asarray(kl), jax.random.PRNGKey(i))
        pmeta = pstep(_torch_batch(sel), kl)
        for k in jmeta:
            assert rel_err(pmeta[k], jmeta[k]) <= 1e-5, (i, k, float(pmeta[k]), float(jmeta[k]))
        assert float(pmeta["skipped_nan"]) == 0.0
    assert opt.count == 1 and opt.mini_step == 0
    ref = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    frozen = _STAGE_FROZEN_MODULES[stage]
    after = port.state_dict()
    for k, v in after.items():
        if k.split(".")[0] in frozen:
            assert torch.equal(v, before[k]), f"frozen {k} moved"
            assert np.array_equal(ref[k], before[k].numpy()), f"JAX moved frozen {k}"
        else:
            assert rel_err(v, ref[k]) <= 1e-5, (k, rel_err(v, ref[k]))
            if before[k].abs().max() > 0:
                assert not torch.equal(v, before[k]), f"{k} did not move"
    if stage == 1:
        # the encoder's attention and FF layers: no gradient, and still
        # moved as optax moves them, by -lr·p
        lr = float(jax_optim.noam_warmup_schedule(0.1, WARMUP)(jnp.asarray(0)))
        k = "encoder.layers.0.pos_ff.CoreNet.0.weight"
        assert rel_err(after[k] - before[k], -lr * before[k].numpy()) < 1e-3


def test_reset_opt_state_at_the_hand_off(tmp_path):
    cache = _FakeCache()
    trainer = pft.FastPitchTrainer(cache, pft.FastPitchTrainConfig(
        output_dir=str(tmp_path), batch_size=2, target_bs=4, warmup_steps=5), CFG,
        device="cpu")
    trainer.setup()
    grads = [torch.ones_like(p) for p in trainer.model.parameters()]
    for _ in range(3):
        trainer.opt.step(grads)
    assert trainer.opt.count == 1 and trainer.opt.mini_step == 1
    trainer.early.finished = True
    assert trainer.finish_epoch([1.0]) is False and trainer.stage == 2
    opt = trainer.opt
    assert opt.count == 0 and opt.mini_step == 0
    assert all(float(t.abs().max()) == 0 for t in opt.mu + opt.nu + opt.acc)
    assert opt.learning_rate() == opt.schedule(0)  # the warm-up starts again
    assert opt.train_mask == fastpitch_stage_mask(trainer.model, 2)


class _FakeCache:
    """The cache surface the trainer reads without a dataset."""
    items = [object()] * 10

    def has_durations(self):
        return False

    def pitch_stats(self):
        return {"mean": 120.0, "std": 30.0}


def test_finish_epoch_and_early_stop_match_jax(tmp_path):
    """A scripted loss sequence through both trainers' ``finish_epoch``: the
    same stage after every epoch, the same early-stop state, stage 4's end."""
    jcfg = jft.FastPitchTrainConfig(output_dir=str(tmp_path / "jax"), epochs_per_checkpoint=10 ** 6)
    pcfg = pft.FastPitchTrainConfig(output_dir=str(tmp_path / "port"),
                                    epochs_per_checkpoint=10 ** 6)
    jt = jft.FastPitchTrainer.__new__(jft.FastPitchTrainer)
    # the JAX trainer's bookkeeping without its model: finish_epoch reads the
    # stage, the early-stop state, the graphs and the logger; its checkpoint
    # (each stage's end) is stubbed out
    from xva_trainer_tpu.train.metrics import GraphsWriter, ThroughputMeter, TrainingLogger

    jt.cfg, jt.cache, jt.stage, jt.epoch, jt.total_iter = jcfg, _FakeCache(), 1, 0, 0
    jt.target_deltas = {s: jft.fastpitch_target_delta(s, 10) for s in (1, 2, 3, 4)}
    jt.graphs = GraphsWriter(jcfg.output_dir, (1, 2, 3, 4), jt.target_deltas)
    jt.logger, jt.meter, jt.tb = TrainingLogger(jcfg.output_dir), ThroughputMeter(), None
    jt._stage_objects = lambda: setattr(jt, "early", JaxEarlyStop(
        target_delta=jt.target_deltas[jt.stage], min_epochs=jft.fastpitch_min_epochs(jt.stage)))
    jt._stage_objects()
    jt.reset_opt_state = jt.save_checkpoint = lambda: None
    pt = pft.FastPitchTrainer(_FakeCache(), pcfg, CFG, device="cpu")
    pt.save_checkpoint = lambda: None
    # relative drops of 1e-5 an epoch (below every stage's target), and one
    # drop of 20% in stage 2, which resets its patience until it leaves the
    # 20-epoch window
    losses = 5.0 * (1 - 1e-5) ** np.arange(120)
    losses[8:] *= 0.8
    stages = []
    for avg in losses:
        ends = [t.finish_epoch([avg, avg]) for t in (jt, pt)]
        assert ends[0] == ends[1]
        assert pt.stage == jt.stage and pt.epoch == jt.epoch
        assert pt.early.to_dict() == jt.early.to_dict()
        stages.append(pt.stage)
        if ends[0]:
            break
    assert stages[-1] == 4 and ends[0] and sorted(set(stages)) == [1, 2, 3, 4]
    with open(os.path.join(jcfg.output_dir, "graphs.json")) as f, \
            open(os.path.join(pcfg.output_dir, "graphs.json")) as g:
        assert json.load(f) == json.load(g)
    assert EarlyStopState.from_dict(pt.early.to_dict()).to_dict() == pt.early.to_dict()


# ---------------- a tiny dataset for the trainer-level tests ----------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from xva_trainer_tpu.data.dataset import FeatureCache as JaxFeatureCache
    from xva_trainer_tpu.data.text import TextProcessor as JaxTextProcessor
    from xva_trainer_tpu_torch.data.audio_io import save_wav

    path = str(tmp_path_factory.mktemp("fpds") / "ds")
    os.makedirs(os.path.join(path, "wavs"))
    rng = np.random.default_rng(0)
    lines = []
    for i in range(5):
        t = np.arange(int(22050 * rng.uniform(0.4, 0.9))) / 22050
        y = 0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t) + 0.01 * rng.standard_normal(len(t))
        save_wav(os.path.join(path, "wavs", f"it{i}.wav"), y.astype(np.float32))
        lines.append(f"it{i}.wav|sample number {i}")
    with open(os.path.join(path, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    JaxFeatureCache(path, JaxTextProcessor().encode, use_pallas=False).build()
    return path


def _port_trainer(path, out, target_bs=4, **kw):
    from xva_trainer_tpu_torch.data.dataset import FeatureCache
    from xva_trainer_tpu_torch.data.text.processor import TextProcessor

    cache = FeatureCache(path, TextProcessor().encode, device="cpu")
    cfg = pft.FastPitchTrainConfig(output_dir=out, batch_size=2, target_bs=target_bs,
                                   use_amp=False, **kw)
    return pft.FastPitchTrainer(cache, cfg, CFG, device="cpu"), cache


def _port_batcher(cache, **kw):
    from xva_trainer_tpu_torch.data.dataset import Bucket, BucketBatcher

    return BucketBatcher(cache, batch_size=2, buckets=[Bucket(32, 96)], with_prior=False,
                         device_prior=True, **kw)


def test_extract_durations_match_jax(dataset, tmp_path):
    """The port's ``extract_durations`` against the JAX trainer's method, run
    on a JAX trainer holding only what that method reads (its model, state,
    mesh, cache and logger), so that no init or train step is compiled."""
    import shutil
    import threading

    from xva_trainer_tpu.data.dataset import Bucket as JaxBucket
    from xva_trainer_tpu.data.dataset import BucketBatcher as JaxBucketBatcher
    from xva_trainer_tpu.data.dataset import FeatureCache as JaxFeatureCache
    from xva_trainer_tpu.data.text import TextProcessor as JaxTextProcessor
    from xva_trainer_tpu.parallel.mesh import make_mesh
    from xva_trainer_tpu.train.metrics import TrainingLogger

    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    shutil.copytree(dataset, jpath)
    shutil.copytree(dataset, ppath)
    params = seeded_fastpitch(JCFG, seed=3, t_text=32, t_mel=96)
    jcache = JaxFeatureCache(jpath, JaxTextProcessor().encode, use_pallas=False)
    jt = jft.FastPitchTrainer.__new__(jft.FastPitchTrainer)
    jt.cache, jt.model, jt.mesh = jcache, JaxFastPitch(JCFG), make_mesh(n_data=1)
    jt.cfg = jft.FastPitchTrainConfig(output_dir=str(tmp_path / "jo"), batch_size=2)
    jt.logger, jt._memo_lock, jt._align_fn = TrainingLogger(jt.cfg.output_dir), threading.Lock(), None
    jt.state = jft.TrainState(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=None,
                              step=jnp.zeros((), jnp.int32))
    jbatcher = JaxBucketBatcher(jcache, batch_size=2, buckets=[JaxBucket(32, 96)],
                                with_prior=False, device_prior=True)
    assert jt.extract_durations(jbatcher) == 5

    pt, pcache = _port_trainer(ppath, str(tmp_path / "po"))
    pt.model.load_state_dict(port_fastpitch(params, CFG).state_dict())
    batcher = _port_batcher(pcache)
    assert pt.extract_durations(batcher) == 5 and batcher.use_durs
    for it in pcache.items:
        ours, ref = pcache.load_durations(it.item_id), jcache.load_durations(it.item_id)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), it.item_id
        assert ours.sum() == pcache.load_item(it)["mel"].shape[1]
    assert pcache.has_durations()


def test_checkpoint_resume_round_trip(dataset, tmp_path):
    """Two stage-1 epochs of 3 micro-steps at ``grad_accum`` 4 (the
    accumulator left mid-update), a checkpoint,
    then a new trainer resumed from it: parameters, the LAMB moments and
    counts, the accumulator, the stage, epoch and early-stop state equal."""
    import shutil

    path = str(tmp_path / "ds")
    shutil.copytree(dataset, path)
    out = str(tmp_path / "out")
    t1, cache = _port_trainer(path, out, target_bs=8, epochs_per_checkpoint=1)
    batcher = _port_batcher(cache)
    t1.setup(batcher)
    for _ in range(2):
        losses, _ = t1.run_epoch(batcher, torch.Generator().manual_seed(0))
        t1.finish_epoch(losses)
    assert t1.opt.mini_step == 2 and t1.opt.count == 1 and t1.total_iter == 6
    assert t1.ckpt.latest_step() == 6
    t2, _ = _port_trainer(path, out, target_bs=8)
    t2.setup(batcher)
    for a, b in zip(t1.model.state_dict().values(), t2.model.state_dict().values()):
        assert torch.equal(a, b)
    s1, s2 = t1.opt.state_dict(), t2.opt.state_dict()
    assert (s1["count"], s1["mini_step"]) == (s2["count"], s2["mini_step"])
    for name in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(s1[name], s2[name]))
    assert (t2.stage, t2.epoch, t2.total_iter) == (t1.stage, t1.epoch, t1.total_iter)
    assert t2.early.to_dict() == t1.early.to_dict()
    # a JAX orbax directory with none of the port's checkpoints is refused
    jax_dir = str(tmp_path / "jaxout")
    os.makedirs(os.path.join(jax_dir, "FastPitch_12"))
    t3, _ = _port_trainer(path, jax_dir)
    with pytest.raises(RuntimeError, match="orbax"):
        t3.setup(batcher)


# ---------------- export and warm start ----------------


def test_export_matches_jax_and_loads_in_jax(tmp_path):
    params = seeded_fastpitch(JDEEP, seed=4)
    port = port_fastpitch(params, DEEP)
    stats = (121.5, 33.25)
    jax_ckpt.export_fastpitch_v2(params["params"], str(tmp_path / "jax.pt"), "v",
                                 model_cfg=JDEEP, pitch_stats=stats)
    export_fastpitch_v2(port, str(tmp_path / "port.pt"), "v", pitch_stats=stats)
    ours = torch.load(tmp_path / "port.pt", weights_only=True)
    ref = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert set(ours) == set(ref)
    assert set(ours) == ({r.torch_key for r in jax_map.fastpitch_rules()}
                         | set(jax_map.fastpitch_extra_keys()))
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == torch.float16, k
        assert ours[k].shape == ref[k].shape, k
        ulp = np.spacing(np.abs(ref[k].float().numpy()).astype(np.float16)).astype(np.float32)
        assert (np.abs(ours[k].float().numpy() - ref[k].float().numpy()) <= ulp).all(), k
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)
    # JAX's loader reads the port's file
    loaded, meta = jax_map.load_fastpitch_checkpoint(str(tmp_path / "port.pt"))
    assert meta["pitch_mean"] == np.float16(121.5) and meta["pitch_std"] == np.float16(33.25)
    flat = _flat_deep(loaded)
    for k, v in port.state_dict().items():
        assert np.array_equal(flat[k], v.half().float().numpy()), k


def _flat_deep(params):
    from xva_trainer_tpu_torch.interop.convert import fastpitch_state_dict

    return {k: v.numpy() for k, v in fastpitch_state_dict(params, DEEP).items()}


def test_warm_start_from_a_jax_export(tmp_path, dataset):
    """The port's trainer warm-started from a ``.pt`` JAX's export wrote:
    the fp16 values, exactly; a training checkpoint's ``training_stage``
    sets the stage."""
    params = seeded_fastpitch(JDEEP, seed=5)
    path = str(tmp_path / "base.pt")
    jax_ckpt.export_fastpitch_v2(params["params"], path, "base", model_cfg=JDEEP)
    from xva_trainer_tpu_torch.data.dataset import FeatureCache
    from xva_trainer_tpu_torch.data.text.processor import TextProcessor

    cache = FeatureCache(dataset, TextProcessor().encode, device="cpu")
    trainer = pft.FastPitchTrainer(cache, pft.FastPitchTrainConfig(
        output_dir=str(tmp_path / "out")), DEEP, device="cpu")
    trainer.setup(pretrained_ckpt=path)
    ref = torch.load(path, weights_only=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, ref[k].float()), k
    assert trainer.stage == 1
    wrapped = str(tmp_path / "train_ckpt.pt")
    torch.save({"state_dict": {"module." + k: v for k, v in ref.items()},
                "training_stage": 3, "epoch": 7}, wrapped)
    model = port_fastpitch(params, DEEP)
    meta = load_fastpitch_checkpoint(wrapped, model)
    _, jmeta = jax_map.load_fastpitch_checkpoint(wrapped)
    assert meta == jmeta and meta["training_stage"] == 3
    t2 = pft.FastPitchTrainer(cache, pft.FastPitchTrainConfig(
        output_dir=str(tmp_path / "out2")), DEEP, device="cpu")
    t2.setup(pretrained_ckpt=wrapped)
    assert t2.stage == 3 and t2.opt.train_mask == fastpitch_stage_mask(t2.model, 3)


# ---------------- v2 inference and Griffin-Lim ----------------


def test_v2_inference_matches_jax(tmp_path):
    params = seeded_fastpitch(JCFG, seed=6)
    jgen_cfg, gen_cfg = JaxHifiganConfig(**GEN_KW), HifiganConfig(**GEN_KW)
    shapes = jax.eval_shape(JaxGenerator(jgen_cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 80)))
    gparams = _seeded(shapes, 7)
    ref_model = jax_pipeline.V2InferenceModel(params, gparams, JCFG, jgen_cfg, mel_max_len=256)
    gen = Generator(gen_cfg)
    gen.load_state_dict(hifigan_v2_state_dict(gparams, gen_cfg), strict=True)
    ours = pipeline.V2InferenceModel(port_fastpitch(params, CFG), gen, mel_max_len=256)
    for text in ("Hello there, this is a test.", "A second, longer sentence to say."):
        ids = np.pad(ours.tp.encode(text), (0, 256 - len(ours.tp.encode(text))))
        jwav, jlens = ref_model._infer(params, gparams, jnp.asarray(ids)[None])
        jmel = ref_model.model.apply(params, jnp.asarray(ids)[None], method=JaxFastPitch.infer,
                                     mel_max_len=256)["mel_out"]
        tokens = torch.from_numpy(ids.astype(np.int64))[None]
        with torch.no_grad():
            pmel = ours.model.infer(tokens, mel_max_len=256)["mel_out"]
            wav, lens = ours.infer(tokens)
        assert np.array_equal(lens.numpy(), np.asarray(jlens))
        assert rel_err(pmel, jmel) < 1e-4
        assert rel_err(wav, np.asarray(jwav)) < 1e-4
        got = ours.tts(text)
        assert got.shape == (int(jlens[0]) * 256,)
        assert rel_err(got, np.asarray(ref_model.tts(text))) < 1e-4
    path = ours.export_wav("Hello there.", str(tmp_path / "out.wav"))
    assert os.path.getsize(path) > 44


def test_istft_and_griffin_lim_match_jax(monkeypatch):
    rng = np.random.default_rng(8)
    mag = np.abs(rng.standard_normal((513, 24))).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    spec = mag * np.exp(1j * ph)
    close_to = rel_err(pgl.istft(torch.from_numpy(spec.astype(np.complex64))),
                       jgl.istft(jnp.asarray(spec.astype(np.complex64))))
    assert close_to < 1e-5
    monkeypatch.setattr(jgl.jax.random, "uniform", lambda *a, **k: jnp.asarray(ph))
    ref = jgl.griffin_lim(jnp.asarray(mag), n_iter=3)
    ours = pgl.griffin_lim(torch.from_numpy(mag), n_iter=3, angles=torch.from_numpy(ph))
    assert rel_err(ours, ref) < 1e-4
    log_mel = (rng.standard_normal((80, 24)) - 4).astype(np.float32)
    ref = jgl.mel_to_wav(jnp.asarray(log_mel), n_iter=2)
    ph2 = np.asarray(ph[:, :24])
    ours = pgl.mel_to_wav(torch.from_numpy(log_mel), n_iter=2, angles=torch.from_numpy(ph2))
    assert ours.shape == ref.shape and rel_err(ours, ref) < 1e-4
