"""Port parity: the v2 HiFi-GAN step in both orders, its AMP form, the
segment sampler and ``HifiganTrainer`` (learning rate, early stop, resume,
export) against the JAX package, with weights carried by ``convert.py``, at
reduced sizes: ``HifiganDiscriminator(periods=(2, 3), n_scales=2)``, a
generator 16 channels wide with one resblock kernel, 2 048-sample segments
(8 mel frames). Tolerances: the losses within 1e-5 relative; each
updated parameter tensor within 1e-5 relative in the L2 norm, and no
element off by more than two AdamW steps (2·lr: an element whose gradient
is at fp32's noise, ~1e-9 against the tensor's largest, sits in Adam's eps
regime, where the two packages' sums of the same terms move it anywhere in
[-lr, lr]); the spectral norm's ``u`` within 1e-5 of its max abs; the AMP
step's losses within 5% of fp32's; the sampler, learning rate, early stop
and resume exactly."""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from torch_v3_common import _seeded
from xva_trainer_tpu.models.hifigan import Generator as JaxGenerator
from xva_trainer_tpu.models.hifigan import HifiganConfig as JaxHifiganConfig
from xva_trainer_tpu.models.hifigan import HifiganDiscriminator as JaxHifiganDiscriminator
from xva_trainer_tpu.ops.stft import MelConfig as JaxMelConfig
from xva_trainer_tpu.train import hifigan_trainer as jht
from xva_trainer_tpu.train.early_stop import EarlyStopState as JaxEarlyStopState
from xva_trainer_tpu.train.metrics import GraphsWriter as JaxGraphsWriter
from xva_trainer_tpu_torch.interop.convert import hifigan_v2_disc_state_dict, hifigan_v2_state_dict
from xva_trainer_tpu_torch.models.hifigan import Generator, HifiganConfig, HifiganDiscriminator
from xva_trainer_tpu_torch.ops.stft import MelConfig
from xva_trainer_tpu_torch.train import hifigan_trainer as pht
from xva_trainer_tpu_torch.train.optim import GanOptimizer

PERIODS, SCALES, T, B = (2, 3), 2, 2048, 2
GEN_KW = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),))
LR = 2e-4
LOSSES = ("mel_l1", "adv", "fm", "g_loss", "d_loss")


def _jax_tx():
    # the JAX trainer's optimiser (hifigan_trainer.py:272-277)
    return optax.inject_hyperparams(optax.adamw)(learning_rate=LR, b1=0.8, b2=0.99,
                                                 weight_decay=0.01)


def _segments(n=B, length=T, seed=0):
    """Tones plus noise, (n, length, 1) in JAX's layout."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 22050.0
    y = np.stack([0.4 * np.sin(2 * np.pi * (180.0 + 70 * i) * t) for i in range(n)])
    return np.clip(y + 0.02 * rng.standard_normal(y.shape), -1, 1).astype(np.float32)[..., None]


def _port_models(g_params, d_vars):
    gen = Generator(HifiganConfig(**GEN_KW))
    gen.load_state_dict(hifigan_v2_state_dict(g_params, gen.cfg), strict=True)
    disc = HifiganDiscriminator(PERIODS, SCALES)
    disc.load_state_dict(hifigan_v2_disc_state_dict(d_vars["params"], d_vars["batch_stats"]),
                         strict=True)
    return gen, disc


def _port_step(g_params, d_vars, seg, *, d_first=False, use_amp=False):
    gen, disc = _port_models(g_params, d_vars)
    g_opt = GanOptimizer(gen.parameters(), float(np.float32(LR)), weight_decay=0.01, gamma=1.0)
    d_opt = GanOptimizer(disc.parameters(), float(np.float32(LR)), weight_decay=0.01, gamma=1.0)
    step = pht.make_gan_step(gen, disc, g_opt, d_opt, MelConfig(), use_amp=use_amp,
                             d_first=d_first)
    meta = step(torch.from_numpy(np.ascontiguousarray(seg.transpose(0, 2, 1))))
    return {k: float(v) for k, v in meta.items()}, gen.state_dict(), disc.state_dict()


@pytest.fixture(scope="module")
def gan_case():
    """Seeded JAX weights (shapes traced, not compiled), a batch, and one
    fp32 JAX step in each order from them (two compiles, shared by the
    tests)."""
    jgen = JaxGenerator(JaxHifiganConfig(**GEN_KW))
    jdisc = JaxHifiganDiscriminator(periods=PERIODS, n_scales=SCALES)
    seg = _segments()
    g_params = _seeded(jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, T // 256, 80))), 11)
    d_vars = _seeded(jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), jnp.asarray(seg),
                                    jnp.asarray(seg)), 12)
    out = {}
    for d_first in (False, True):
        g_tx, d_tx = _jax_tx(), _jax_tx()
        gp = jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(g_params))
        dp = jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(d_vars))
        state = jht.GanState(g_params=gp, d_params={"params": dp["params"]},
                             d_stats=dp["batch_stats"], g_opt=g_tx.init(gp),
                             d_opt=d_tx.init({"params": dp["params"]}),
                             step=jnp.zeros((), jnp.int32))
        step = jht.make_gan_step(jgen, jdisc, g_tx, d_tx, JaxMelConfig(), use_amp=False,
                                 d_first=d_first)
        new, meta = step(state, jnp.asarray(seg))
        new = jax.device_get(new)
        out[d_first] = {
            "meta": {k: float(v) for k, v in meta.items()},
            "gen": hifigan_v2_state_dict(new.g_params, HifiganConfig(**GEN_KW)),
            "disc": hifigan_v2_disc_state_dict(new.d_params, new.d_stats),
            "lr": float(new.g_opt.hyperparams["learning_rate"])}
    return g_params, d_vars, seg, out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _updated_close(ours: torch.Tensor, ref: torch.Tensor) -> bool:
    """An updated parameter tensor against JAX's: 1e-5 relative in the L2
    norm, and every element within two AdamW steps."""
    d = (ours - ref).double()
    return (float(d.norm()) <= 1e-5 * float(ref.double().norm())
            and float(d.abs().max()) <= 2 * LR * (1 + 0.01 * float(ref.abs().max())))


@pytest.mark.parametrize("d_first", [False, True], ids=["g_first", "d_first"])
def test_gan_step_matches_jax(gan_case, d_first):
    """One fp32 step from the same weights and batch: the five losses, every
    updated G and D parameter and MSD disc 0's ``u`` (after the D step's
    two iterations; in ``d_first`` the G step then runs against that u and
    the updated D) within the module's bars of JAX's."""
    g_params, d_vars, seg, out = gan_case
    meta, gen_sd, disc_sd = _port_step(g_params, d_vars, seg, d_first=d_first)
    ref = out[d_first]
    for k in LOSSES:
        assert abs(meta[k] - ref["meta"][k]) <= 1e-5 * abs(ref["meta"][k]), (k, meta[k], ref["meta"][k])
    old_g = hifigan_v2_state_dict(g_params, HifiganConfig(**GEN_KW))
    for k, v in ref["gen"].items():
        assert _updated_close(gen_sd[k], v), k
        assert not torch.equal(v, old_g[k]), k  # every generator tensor moved
    for k, v in ref["disc"].items():
        if k.endswith("weight_v"):  # the port's last v, never read; the carry's is from u
            continue
        if k.endswith("weight_u"):
            assert _rel(disc_sd[k], v) < 1e-5, k
        else:
            assert _updated_close(disc_sd[k], v), k
    u_keys = [k for k in ref["disc"] if k.endswith("weight_u")]
    old_u = hifigan_v2_disc_state_dict(d_vars["params"], d_vars["batch_stats"])
    assert len(u_keys) == 8 and all(not torch.equal(disc_sd[k], old_u[k]) for k in u_keys)


def test_orderings_same_d_update_different_g_update(gan_case):
    """tests/test_hifigan_ordering.py's facts on the port: both orders give
    the same D update (the same fakes from the same initial G), different G
    updates (stale against updated D), and finite losses."""
    g_params, d_vars, seg, _ = gan_case
    (m_a, g_a, d_a), (m_b, g_b, d_b) = (_port_step(g_params, d_vars, seg, d_first=f)
                                        for f in (False, True))
    assert all(np.isfinite(m[k]) for m in (m_a, m_b) for k in LOSSES)
    for k in d_a:
        np.testing.assert_allclose(d_a[k].numpy(), d_b[k].numpy(), atol=1e-6, err_msg=k)
    assert max(float((g_a[k] - g_b[k]).abs().max()) for k in g_a) > 0.0


def test_amp_step_within_five_percent(gan_case):
    """The step under bf16 autocast: its G and D losses within 5% of the
    fp32 step's (JAX's)."""
    g_params, d_vars, seg, out = gan_case
    meta, _, _ = _port_step(g_params, d_vars, seg, use_amp=True)
    for k in ("g_loss", "d_loss", "mel_l1"):
        assert abs(meta[k] - out[False]["meta"][k]) <= 0.05 * abs(out[False]["meta"][k]), k


def _write_dataset(root, lengths, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"))
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        for i, n in enumerate(lengths):
            t = np.arange(n) / 22050.0
            y = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
            y = y + 0.01 * rng.standard_normal(n)
            wavfile.write(os.path.join(root, "wavs", f"c{i}.wav"), 22050,
                          np.round(np.clip(y, -1, 1) * 32767).astype(np.int16))
            f.write(f"c{i}.wav|clip {i}\n")
    return str(root)


@pytest.mark.parametrize("n,batch,data_mult", [(5, 4, None), (5, 4, 2), (3, 8, 1)],
                         ids=["data_mult_from_size", "data_mult_given", "tiny_dataset"])
def test_segment_sampler_matches_jax(tmp_path, n, batch, data_mult):
    """One seed gives JAX's segments: the data multiplier round(1000/n) or
    the given one, a permutation each, a crop start each, and the choice
    branch of a dataset smaller than a batch; clips shorter than a segment
    padded."""
    lengths = [9000, 5000, 20000, 8192, 12000][:n]
    ds = _write_dataset(tmp_path / "ds", lengths)
    ours = pht.SegmentSampler(ds, batch, seed=3, data_mult=data_mult)
    ref = jht.SegmentSampler(ds, batch, seed=3, data_mult=data_mult)
    assert ours.data_mult == ref.data_mult == (data_mult or round(1000 / n))
    assert len(ours) == len(ref)
    for _ in range(2):
        a, b = list(ours.epoch()), list(ref.epoch())
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture()
def reduced(monkeypatch):
    """The trainer's discriminator cut to PERIODS and SCALES (a test-only
    patch of the module's name)."""
    monkeypatch.setattr(pht, "HifiganDiscriminator",
                        lambda: HifiganDiscriminator(PERIODS, SCALES))


def _port_trainer(ds, out_dir, **kw):
    cfg = pht.HifiganTrainConfig(output_dir=str(out_dir), batch_size=2, use_amp=False,
                                 data_mult=1, **kw)
    return pht.HifiganTrainer(ds, cfg, HifiganConfig(**GEN_KW), device="cpu")


class _NoCheckpoint:
    def save(self, *a, **kw):
        pass


def _jax_trainer(out_dir):
    """A JAX HifiganTrainer with what ``finish_epoch`` reads (made without
    ``__init__``, so no full-size init compiles): the config, an
    inject_hyperparams AdamW state on a stand-in parameter, the early stop,
    graphs.json; no checkpoint write."""
    tr = jht.HifiganTrainer.__new__(jht.HifiganTrainer)
    tr.cfg = jht.HifiganTrainConfig(output_dir=str(out_dir))
    p = {"w": jnp.zeros((3,))}
    tx = _jax_tx()
    tr.state = jht.GanState(g_params=p, d_params=p, d_stats={}, g_opt=tx.init(p),
                            d_opt=tx.init(p), step=jnp.zeros((), jnp.int32))
    tr.early = JaxEarlyStopState(target_delta=jht.HIFIGAN_TARGET_DELTA, span=jht.HIFIGAN_SPAN,
                                 min_epochs=jht.HIFIGAN_MIN_EPOCHS)
    tr.graphs = JaxGraphsWriter(str(out_dir), (5,), {5: jht.HIFIGAN_TARGET_DELTA})
    tr.ckpt, tr.tb, tr.epoch, tr.total_iter = _NoCheckpoint(), None, 0, 0
    tr.meter = jht.ThroughputMeter()
    tr.logger = jht.TrainingLogger(str(out_dir), also_print=False)
    return tr


def test_learning_rate_matches_jax(tmp_path, reduced):
    """After three ``finish_epoch``s the learning rate of both optimisers is
    JAX's ``opt_state.hyperparams`` value, fp32(2e-4 · 0.999³), bit for bit;
    the first step's is fp32(2e-4), as JAX's."""
    ds = _write_dataset(tmp_path / "ds", [9000, 10000])
    ours = _port_trainer(ds, tmp_path / "port")
    ref = _jax_trainer(tmp_path / "jax")
    assert ours.g_opt.lr == float(ref.state.g_opt.hyperparams["learning_rate"])
    for _ in range(3):
        ours.finish_epoch([])
        ref.finish_epoch([])
    want = float(ref.state.g_opt.hyperparams["learning_rate"])
    assert ours.g_opt.lr == ours.d_opt.lr == want == float(np.float32(2e-4 * 0.999 ** 3))
    assert ours.g_opt.learning_rate() == want
    assert ours.g_opt.state_dict()["lr"] == want


def test_early_stop_matches_jax(tmp_path, reduced):
    """A scripted sequence of epoch losses that settles: the early-stop dict,
    the epoch at which it finishes, the learning rate and graphs.json equal
    JAX's."""
    ds = _write_dataset(tmp_path / "ds", [9000, 10000])
    ours = _port_trainer(ds, tmp_path / "port")
    ours.ckpt = _NoCheckpoint()
    ref = _jax_trainer(tmp_path / "jax")
    losses = [1.0 / (1 + 0.5 * e) for e in range(12)] + [0.1 + 1e-7 * (e % 3) for e in range(30)]
    done_at = None
    for e, loss in enumerate(losses):
        ours.total_iter = ref.total_iter = 10 * (e + 1)
        a, b = ours.finish_epoch([loss, loss]), ref.finish_epoch([loss, loss])
        assert a == b and ours.early.to_dict() == ref.early.to_dict(), e
        if a:
            done_at = e
            break
    assert done_at is not None and done_at >= jht.HIFIGAN_MIN_EPOCHS
    assert ours.g_opt.lr == float(ref.state.g_opt.hyperparams["learning_rate"])
    with open(tmp_path / "port" / "graphs.json") as f, open(tmp_path / "jax" / "graphs.json") as g:
        assert json.load(f) == json.load(g)


def test_resume_is_bit_identical(tmp_path, reduced):
    """Two steps and an epoch's checkpoint, then a second trainer on the
    directory: both models (the spectral norm's ``u`` and ``v`` included),
    both optimisers (moments, count, lr), the step, epoch and early stop
    bit-identical; it then trains on."""
    ds = _write_dataset(tmp_path / "ds", [9000, 12000, 10000, 15000])
    a = _port_trainer(ds, tmp_path / "out")
    a.setup()
    res = a.train(max_epochs=1, max_iters=2)
    assert res["total_iter"] == 2 and res["epoch"] == 1
    assert a.ckpt.latest_step() == 2
    b = _port_trainer(ds, tmp_path / "out")
    b.setup()
    for m_a, m_b in ((a.gen, b.gen), (a.disc, b.disc)):
        sa, sb = m_a.state_dict(), m_b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for o_a, o_b in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        s1, s2 = o_a.state_dict(), o_b.state_dict()
        assert (s1["count"], s1["lr"]) == (s2["count"], s2["lr"]) == (2, float(np.float32(LR * 0.999)))
        assert all(torch.equal(x, y) for n in ("mu", "nu") for x, y in zip(s1[n], s2[n]))
    assert (b.epoch, b.total_iter, b.early.to_dict()) == (a.epoch, a.total_iter, a.early.to_dict())
    assert b.train(max_epochs=1)["total_iter"] == 4


def test_export_matches_jax(tmp_path, reduced, gan_case):
    """``{voice}.hg.pt`` of the same generator parameters: {'generator': sd}
    with JAX's export's key set, shapes and fp32 values (the reference
    layout, ``ups`` per input channel), within 1e-6 relative."""
    g_params = gan_case[0]
    ds = _write_dataset(tmp_path / "ds", [9000, 10000])
    ours = _port_trainer(ds, tmp_path / "port")
    ours.gen.load_state_dict(hifigan_v2_state_dict(g_params, ours.gen.cfg), strict=True)
    ref = jht.HifiganTrainer.__new__(jht.HifiganTrainer)
    ref.cfg = jht.HifiganTrainConfig(output_dir=str(tmp_path / "jax"))
    ref.gen = JaxGenerator(JaxHifiganConfig(**GEN_KW))
    ref.state = jht.GanState(g_params=g_params, d_params={}, d_stats={}, g_opt=None, d_opt=None,
                             step=0)
    os.makedirs(tmp_path / "jax")
    a = torch.load(ours.export("voice", str(tmp_path)), weights_only=True)
    b = torch.load(ref.export("voice"), weights_only=True)
    assert list(a) == list(b) == ["generator"]
    a, b = a["generator"], b["generator"]
    assert set(a) == set(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == torch.float32 for k in b)
    assert all(b[k].shape[1:] == (1, 1) for k in b if ".ups." in k and k.endswith("weight_g"))
    for k in b:
        assert _rel(a[k], b[k].float()) < 1e-6, k


def test_gan_converges():
    """tests/test_convergence.py::test_hifigan_gan_converges at the reduced
    sizes: 20 adversarial steps (AdamW at 2e-3) on a tonal target from a
    narrow generator, 2 048-sample segments; the mel L1 of the last 6 steps
    under 0.9 × the first 6's, every one finite. Both models start from the
    port's own seeded initialisation, as the JAX test starts from flax's
    (unit-norm filters in both)."""
    kw = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),))
    torch.manual_seed(0)
    gen = Generator(HifiganConfig(**kw))
    disc = HifiganDiscriminator(PERIODS, SCALES)
    t = np.arange(T) / 22050.0
    seg = torch.from_numpy(np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t),
                                     0.4 * np.sin(2 * np.pi * 330.0 * t)]).astype(np.float32))
    step = pht.make_gan_step(gen, disc, GanOptimizer(gen.parameters(), 2e-3, gamma=1.0),
                             GanOptimizer(disc.parameters(), 2e-3, gamma=1.0), MelConfig(),
                             use_amp=False)
    mels = [float(step(seg[:, None])["mel_l1"]) for _ in range(20)]
    assert np.isfinite(mels).all()
    assert np.mean(mels[-6:]) < 0.9 * np.mean(mels[:6]), mels


def test_optimizer_lr_in_its_state():
    """``GanOptimizer``'s state carries a learning rate that was set; a state
    written before it did (the v3 trainer's checkpoints) still loads and
    keeps the optimiser's own."""
    p = [torch.nn.Parameter(torch.ones(3))]
    a = GanOptimizer(p, 2e-4, gamma=1.0)
    a.lr = float(np.float32(2e-4 * 0.999))
    b = GanOptimizer([torch.nn.Parameter(torch.zeros(3))], 2e-4, gamma=1.0)
    b.load_state_dict(a.state_dict())
    assert b.lr == b.learning_rate() == a.lr
    old = {k: v for k, v in a.state_dict().items() if k != "lr"}
    c = GanOptimizer([torch.nn.Parameter(torch.zeros(3))], 1.75e-4)
    c.load_state_dict(old)
    assert c.lr == 1.75e-4
