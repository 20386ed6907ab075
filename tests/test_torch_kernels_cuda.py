"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the fused STFT kernel within 1e-3 (the HiFi-GAN loss mel's full band
included), the MAS kernel with identical paths, a v3 feature cache built on
the card against the same cache built on the CPU, the FastPitch and
HiFi-GAN steps' launches, and the v3 trainer loop at the tiny config
through both kernels (a checkpoint, a resume and an export).

Needs an NVIDIA GPU with nvcc (sm_90a); skips elsewhere. Run on the card
(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from xva_trainer_tpu_torch.ops import _cuda
from xva_trainer_tpu_torch.ops import fused_stft as fs
from xva_trainer_tpu_torch.ops import mas
from xva_trainer_tpu_torch.ops.stft import MelConfig

pytestmark = pytest.mark.cuda
TOL = 1e-3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bucket(device, B=4, T=65536 + 1024, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050.0
    y = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal((B, T))
    return torch.from_numpy(y.astype(np.float32)).to(device)


def _held(y, cfg=MelConfig(), **kw):
    """The kernel's (mel, linear) and the plain version's, after checking that
    they agree at mean and max abs < TOL."""
    out = fs.mel_spectrogram_fused(y, cfg, return_linear=True, **kw)
    ref = fs.mel_spectrogram_fused_reference(y, cfg, return_linear=True, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.is_cuda and bool(torch.isfinite(o).all())
        d = (o - r).abs()
        assert d.mean().item() < TOL and d.max().item() < TOL
    return out, ref


@pytest.mark.parametrize("center,mag_eps", [(None, 0.0), (True, 0.0), (False, 1e-9)])
@pytest.mark.parametrize("return_linear", [True, False])
def test_kernel_matches_plain(cuda, center, mag_eps, return_linear):
    y = _bucket(cuda)
    kw = dict(center=center, mag_eps=mag_eps, return_linear=return_linear)
    before = _cuda.LAUNCHES["fused_stft"]
    out = fs.mel_spectrogram_fused(y, **kw)
    ref = fs.mel_spectrogram_fused_reference(y, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_stft"] == before + 1
    pairs = zip(out, ref) if return_linear else [(out, ref)]
    for o, r in pairs:
        assert o.shape == r.shape and o.is_cuda
        d = (o - r).abs()
        assert d.mean().item() < TOL and d.max().item() < TOL


@pytest.mark.parametrize("return_linear", [True, False])
def test_kernel_hifigan_loss_mel(cuda, return_linear):
    """The HiFi-GAN loss mel: ``LOSS_MEL`` (the full band, its top filter
    ending at the Nyquist bin), ``center=False``, ``mag_eps`` 1e-9, held to
    the plain version, at the GAN step's shape (16 segments of 8 192)."""
    from xva_trainer_tpu_torch.ops.stft import LOSS_MEL

    y = _bucket(cuda, B=16, T=8192)
    kw = dict(center=False, mag_eps=1e-9, return_linear=return_linear)
    out = fs.mel_spectrogram_fused(y, LOSS_MEL, **kw)
    ref = fs.mel_spectrogram_fused_reference(y, LOSS_MEL, **kw)
    torch.cuda.synchronize()
    for o, r in (zip(out, ref) if return_linear else [(out, ref)]):
        assert o.shape == r.shape and o.is_cuda and bool(torch.isfinite(o).all())
        d = (o - r).abs()
        assert d.mean().item() < TOL and d.max().item() < TOL


def test_kernel_nyquist_bin(cuda):
    """An alternating +-0.5 signal puts its energy in bin 512, which the
    kernel takes from Z[0] of its FFT."""
    y = torch.from_numpy(0.5 * (-1.0) ** np.arange(16384)).float().to(cuda).repeat(2, 1)
    (mel, lin), (_, rlin) = _held(y)
    assert (lin[:, 512] - rlin[:, 512]).abs().max().item() < TOL
    assert rlin[:, 512, 4:-4].min().item() > 100  # the energy is where it should be


def test_kernel_silence(cuda):
    (mel, lin), _ = _held(torch.zeros((2, 8192), device=cuda))
    assert (mel - math.log(1e-5)).abs().max().item() < 1e-5
    assert lin.abs().max().item() == 0.0


def test_kernel_full_scale_chirp(cuda):
    t = np.arange(3 * 22050) / 22050.0
    y = np.sign(np.sin(2 * np.pi * (50 * t + 1800 * t * t)))  # +-1, 50 Hz to 10.8 kHz
    _held(torch.from_numpy(y).float().to(cuda)[None].repeat(3, 1))


def test_kernel_win_length_800(cuda):
    _held(_bucket(cuda, B=2, T=30000), MelConfig(win_length=800))


@pytest.mark.parametrize("batch", [1, 3])
def test_kernel_one_frame(cuda, batch):
    (mel, lin), _ = _held(_bucket(cuda, B=batch, T=1024), center=None)
    assert mel.shape == (batch, 80, 1) and lin.shape == (batch, 513, 1)


@pytest.mark.parametrize("shape,center", [((22051,), True), ((3, 22051), None),
                                          ((3, 22051), True)])
def test_kernel_odd_length_rows(cuda, shape, center):
    """Rows of odd length start at every alignment, so the staged spans
    start unaligned."""
    y = _bucket(cuda, B=3, T=22051)
    _held(y[0] if len(shape) == 1 else y, center=center)


@pytest.mark.parametrize("hop", [1024, 1500])
def test_kernel_long_hop(cuda, hop):
    """hop = 1024: frames abut; hop > 1024: each frame is staged on its own."""
    _held(_bucket(cuda, B=2, T=40000), MelConfig(hop_length=hop))


@pytest.mark.parametrize("hop", [128, 200, 256])
def test_kernel_any_hop_and_1d(cuda, hop):
    cfg = MelConfig(hop_length=hop)
    y = _bucket(cuda, B=1, T=30000)[0]
    mel, lin = fs.mel_spectrogram_fused(y, cfg, return_linear=True)
    rmel, rlin = fs.mel_spectrogram_fused_reference(y, cfg, return_linear=True)
    torch.cuda.synchronize()
    assert mel.dim() == 2 and mel.shape == rmel.shape
    assert (mel - rmel).abs().mean().item() < TOL
    assert (lin - rlin).abs().mean().item() < TOL


def test_kernel_rejects_other_n_fft(cuda):
    y = _bucket(cuda, B=1, T=8192)
    with pytest.raises(ValueError, match="n_fft"):
        fs.mel_spectrogram_fused(y, MelConfig(n_fft=512, win_length=512, hop_length=128))


def _voiced_dataset(path, n=10, seed=0):
    """``n`` voiced clips of 0.6-3.5 s in the trainer's dataset layout."""
    from xva_trainer_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed)
    (path / "wavs").mkdir(parents=True)
    lines = []
    for i, sec in enumerate(np.linspace(0.6, 3.5, n)):
        t = np.arange(int(sec * 22050)) / 22050
        ph = 2 * np.pi * np.cumsum(rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * t))) / 22050
        y = sum(np.sin(k * ph) / k for k in range(1, 8)) * 0.3
        save_wav(str(path / "wavs" / f"c{i}.wav"), y + 0.01 * rng.standard_normal(len(t)))
        lines.append(f"c{i}.wav|clip number {i}")
    (path / "metadata.csv").write_text("\n".join(lines) + "\n")
    return str(path)


def test_cache_build_on_card_matches_cpu(cuda, tmp_path):
    """A v3 feature cache built on the card (the fused kernel, one launch a
    group of at most 8 clips) against the same cache built on the CPU (the
    kernel's plain version): the log-compressed linear spectrogram within
    1e-3 mean abs and within 1e-3 max abs on the bins of magnitude 0.1 and
    more (below, fp32 rounding alone moves the log toward the 1e-5 clamp),
    the magnitude within 1e-3 max abs, energy within 1e-3 of
    its max abs, pitch voiced alike on more than 95% of frames and within 2%
    on 95% of the frames both call voiced, tokens, wav and lang_id equal."""
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import XvaFeatureCache

    caches = {}
    for dev in ("cuda", "cpu"):
        ds = _voiced_dataset(tmp_path / dev)
        before = _cuda.LAUNCHES["fused_stft"]
        caches[dev] = XvaFeatureCache(ds, v3_text_to_ids("en"), device=dev)
        caches[dev].build()
        launched = _cuda.LAUNCHES["fused_stft"] - before
        assert launched == (2 if dev == "cuda" else 0)
    for it_a, it_b in zip(caches["cuda"].items, caches["cpu"].items):
        a, b = caches["cuda"].load_item(it_a), caches["cpu"].load_item(it_b)
        assert a["linear"].shape == b["linear"].shape
        la, lb = (np.log(np.maximum(x["linear"], 1e-5)) for x in (a, b))
        assert np.abs(la - lb).mean() < TOL
        assert np.abs(la - lb)[b["linear"] >= 0.1].max() < TOL
        assert np.abs(a["linear"] - b["linear"]).max() < TOL
        assert np.abs(a["energy"] - b["energy"]).max() < TOL * np.abs(b["energy"]).max()
        va, vb = a["pitch"] != 0, b["pitch"] != 0
        assert (va == vb).mean() > 0.95
        both = va & vb
        hz_a, hz_b = (x["pitch"][both] * 123.4384 + 104.606 for x in (a, b))
        assert np.percentile(np.abs(hz_a - hz_b) / hz_b, 95) < 0.02
        for k in ("tokens", "wav", "lang_id"):
            np.testing.assert_array_equal(a[k], b[k])


# ---------------- MAS ----------------


MAS_CASES = {  # name: (B, t_x, t_y)
    "trainer": (64, 192, 768), "one_token": (4, 1, 50), "square": (3, 64, 64),
    "more_tokens": (3, 40, 20), "extreme": (2, 12, 900), "bf16": (64, 192, 768),
    "long_text": (2, 1100, 1500), "start_minus_inf": (8, 192, 768),
    "minus_inf_column": (8, 192, 768), "nan_under_mask": (8, 192, 768),
    "fractional_mask": (8, 192, 768), "non_rectangular_mask": (8, 192, 768),
    "odd_frames": (4, 50, 333), "fastpitch": (16, 256, 896), "long_frames": (2, 40, 7000),
    "fastpitch_stage1": (46, 256, 896)}
MAS_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
# cases in which every active frame holds one nonzero path entry
MAS_ONE_PER_FRAME = ("trainer", "one_token", "square", "more_tokens", "extreme", "bf16",
                     "long_text", "fractional_mask", "odd_frames", "fastpitch",
                     "long_frames", "fastpitch_stage1")


def mas_case(name, device, value_dtype=None, mask_dtype=torch.float32, seed=0):
    """(value, mask) of one MAS case: the trainer's largest bucket with
    ragged lengths, one token, a square, more tokens than frames, extreme
    magnitudes over 900 frames, bf16 values, more than 256 tokens (several
    DP warps, 8-frame tiles, the direction bits in scratch); -inf at (0, 0)
    (the backtrack walks below x = 0), a -inf column at frame 0, NaN under
    the mask, a fractional mask, zeros inside the lengths; an odd t_y (bf16
    rows staged without cp.async); FastPitch's 256 x 896, and at its stage-1
    batch of 46 (every type pair, bf16 values with an fp32 mask among them);
    7 000 frames of 40 tokens (the bits in scratch, one warp). The value is bf16
    for "bf16" unless ``value_dtype`` says otherwise."""
    rng = np.random.default_rng(seed)
    B, tx, ty = MAS_CASES[name]
    value = rng.standard_normal((B, tx, ty))
    if name == "extreme":
        value = value * 3e6 - 2e6
    x_len = rng.integers(max(1, tx // 8), tx + 1, B)
    y_len = rng.integers(max(1, ty // 4), ty + 1, B)
    x_len[0], y_len[0] = tx, ty
    if name == "more_tokens":
        x_len = np.maximum(x_len, y_len + 1).clip(max=tx)
    mask = ((np.arange(tx)[None, :, None] < x_len[:, None, None])
            & (np.arange(ty)[None, None, :] < y_len[:, None, None])).astype(np.float64)
    if name == "start_minus_inf":
        value[:, 0, 0] = -np.inf
    elif name == "minus_inf_column":
        value[:, :, 0] = -np.inf
    elif name == "fractional_mask":
        mask *= rng.uniform(0.2, 1.0, mask.shape)
    elif name in ("nan_under_mask", "non_rectangular_mask"):
        for b in range(B):
            xs = rng.integers(1, max(2, x_len[b]), 4)
            ys = rng.integers(1, max(2, y_len[b]), 4)
            if name == "nan_under_mask":
                value[b, xs, ys] = np.nan
            else:
                mask[b, xs, ys] = 0
        if name == "nan_under_mask":
            value[1, 0, 0] = np.nan
    if value_dtype is None:
        value_dtype = torch.bfloat16 if name == "bf16" else torch.float32
    return (torch.from_numpy(value.astype(np.float32)).to(device, value_dtype),
            torch.from_numpy(mask.astype(np.float32)).to(device, mask_dtype))


@pytest.mark.parametrize("pair", MAS_PAIRS, ids=lambda p: "-".join(str(t)[6:] for t in p))
@pytest.mark.parametrize("name", list(MAS_CASES))
def test_mas_kernel_paths_equal_plain(cuda, name, pair):
    value, mask = mas_case(name, cuda, *pair)
    before = _cuda.LAUNCHES["mas"]
    path = mas.maximum_path(value, mask)
    ref = mas.maximum_path_reference(value, mask)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["mas"] == before + 1
    assert path.dtype == value.dtype and path.shape == value.shape and path.is_cuda
    assert torch.equal(path, ref), int((path != ref).sum())
    if name in MAS_ONE_PER_FRAME:  # one text position per valid frame
        _, y_len = mas.mask_lengths(mask)
        assert torch.equal((path != 0).sum(dim=(1, 2)).long(), y_len.long())


def test_mas_kernel_empty_batch_and_bad_input(cuda):
    value, mask = mas_case("square", cuda)
    before = _cuda.LAUNCHES["mas"]
    assert mas.maximum_path(value[:0], mask[:0]).shape == (0, 64, 64)
    assert _cuda.LAUNCHES["mas"] == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mas.maximum_path(value.half(), mask)
    with pytest.raises(ValueError, match="shared memory"):
        mas.maximum_path(torch.zeros((1, 4096, 4096), device=cuda),
                         torch.ones((1, 4096, 4096), device=cuda))


# ---------------- the v2 FastPitch steps ----------------


def test_fastpitch_steps_on_card(cuda):
    """FastPitch's stage steps at a small width on the card under AMP: the
    stage-1 step (the aligner) launches MAS once, a stage-3 step on
    extracted durations never; the losses finite."""
    from xva_trainer_tpu_torch.models.fastpitch import FastPitch, FastPitchConfig
    from xva_trainer_tpu_torch.train import fastpitch_trainer as pft
    from xva_trainer_tpu_torch.train.optim import LambOptimizer

    torch.manual_seed(0)
    model = FastPitch(FastPitchConfig(symbols_embedding_dim=64, in_fft_n_layers=2,
                                      out_fft_n_layers=2, in_fft_filter_size=128,
                                      out_fft_filter_size=128)).to(cuda).train()
    rng = np.random.default_rng(1)
    B, tx, ty = 4, 64, 256
    in_lens = torch.tensor([64, 40, 20, 1], device=cuda)
    mel_lens = torch.tensor([256, 200, 90, 1], device=cuda)
    durs = torch.zeros((B, tx), device=cuda)
    for b in range(B):
        durs[b, :in_lens[b]] = mel_lens[b] // in_lens[b]
        durs[b, 0] += mel_lens[b] - durs[b].sum()
    batch = {"tokens": torch.from_numpy(rng.integers(1, 148, (B, tx))).to(cuda)
             * (torch.arange(tx, device=cuda)[None] < in_lens[:, None]),
             "in_lens": in_lens, "mel_lens": mel_lens, "durs": durs,
             "mel": torch.randn((B, ty, 80), device=cuda).half() - 4,
             "pitch": torch.randn((B, 1, ty), device=cuda).half(),
             "energy": torch.rand((B, ty), device=cuda).half()}
    gen = torch.Generator(device=cuda).manual_seed(0)
    for stage, use_gt, launches in ((1, False, 1), (3, True, 0)):
        opt = LambOptimizer(model.parameters(), grad_accum=2)
        step = pft.make_stage_step(model, stage, opt, use_gt_durs=use_gt, use_amp=True,
                                   device_prior=True)
        before = _cuda.LAUNCHES["mas"]
        meta = step(batch, 0.1, gen)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["mas"] - before == launches, stage
        assert all(bool(torch.isfinite(v).all()) for v in meta.values()), meta


# ---------------- the v2 HiFi-GAN step ----------------


@pytest.mark.parametrize("d_first", [False, True], ids=["g_first", "d_first"])
def test_hifigan_step_on_card(cuda, d_first):
    """The GAN step at a small width on the card under AMP, in both orders:
    2 ``fused_stft`` launches (the input mel and the real side of the loss
    mel), no MAS; finite losses; the spectral norm's u moved."""
    from xva_trainer_tpu_torch.models.hifigan import (Generator, HifiganConfig,
                                                      HifiganDiscriminator)
    from xva_trainer_tpu_torch.train import hifigan_trainer as pht
    from xva_trainer_tpu_torch.train.optim import GanOptimizer

    torch.manual_seed(0)
    gen = Generator(HifiganConfig(upsample_initial_channel=32)).to(cuda)
    disc = HifiganDiscriminator((2, 3), 2).to(cuda)
    step = pht.make_gan_step(gen, disc, GanOptimizer(gen.parameters(), 2e-4, gamma=1.0),
                             GanOptimizer(disc.parameters(), 2e-4, gamma=1.0),
                             use_amp=True, d_first=d_first)
    u = disc.msd.discriminators[0].convs[0].weight_u.clone()
    before = dict(_cuda.LAUNCHES)
    meta = step(_bucket(cuda, B=4, T=pht.SEGMENT_SIZE)[:, None])
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["fused_stft"] - before["fused_stft"] == 2
    assert _cuda.LAUNCHES["mas"] == before["mas"]
    assert all(bool(torch.isfinite(v).all()) for v in meta.values()), meta
    assert not torch.equal(u, disc.msd.discriminators[0].convs[0].weight_u)


# ---------------- the v3 trainer loop ----------------


def test_trainer_loop_on_card(cuda, tmp_path):
    """``XVAPitchTrainer`` at the tiny config on the card: the loss-seeding
    pass and two updates through both kernels (2 ``fused_stft`` and 1
    ``mas`` launch a micro-step and a seeding batch), a checkpoint each
    update, a resume bit-identical to the saver, one more update, and an
    export that ``serve.load_xvapitch`` loads strictly and serves."""
    from xva_trainer_tpu_torch.data.dataset import Bucket
    from xva_trainer_tpu_torch.data.text import v3_text_to_ids
    from xva_trainer_tpu_torch.data.xva_dataset import XvaBatcher, XvaFeatureCache
    from xva_trainer_tpu_torch.models.xvapitch import XVAPitchConfig
    from xva_trainer_tpu_torch.serve import load_xvapitch, synthesize_v3
    from xva_trainer_tpu_torch.train.xvapitch_trainer import XVAPitchTrainer, XvaTrainConfig

    tiny = XVAPitchConfig(n_vocab=524, big=False, upsample_initial_channel=32,
                          resblock_kernel_sizes=(3,), spec_segment_size=8, mltts_rc=False,
                          text_layers=2, posterior_layers=3, flow_wn_layers=2, num_flows=2,
                          sdp_flows=2, pitch_layers=1)
    cache = XvaFeatureCache(_voiced_dataset(tmp_path / "ds", n=4), v3_text_to_ids("en"))
    cache.build()
    dvec = np.random.default_rng(1).standard_normal(512).astype(np.float32) * 0.1
    out = str(tmp_path / "out")

    def trainer():
        batcher = XvaBatcher([cache], batch_size=4, d_vector=dvec, buckets=[Bucket(64, 320)])
        cfg = XvaTrainConfig(output_dir=out, batch_size=4, target_bs=4, save_step=1)
        return XVAPitchTrainer(batcher, cfg, tiny, device="cuda")

    tr = trainer()
    tr.setup(resume=False)
    _cuda.reset_launch_counts()
    result = tr.train(max_steps=2)
    seeding_batches = 1
    assert result["training_iters"] == 2 and tr.micro_steps == 2 and len(tr.loss_sampling) == 4
    assert _cuda.LAUNCHES["fused_stft"] == 2 * (tr.micro_steps + seeding_batches)
    assert _cuda.LAUNCHES["mas"] == tr.micro_steps + seeding_batches
    assert tr.ckpt._steps() == [1, 2]

    back = trainer()
    back.setup(resume=True)
    for a, b in ((tr.model, back.model), (tr.disc, back.disc)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
    for a, b in ((tr.g_opt, back.g_opt), (tr.d_opt, back.d_opt)):
        assert (a.count, a.mini_step) == (b.count, b.mini_step) == (2, 0)
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))
    assert back.loss_sampling == tr.loss_sampling and back.stage == tr.stage
    back.train(max_steps=3)
    assert back.training_iters == 3 and back.ckpt._steps() == [2, 3]

    path = back.export("card_voice", base_emb=dvec)
    model = load_xvapitch(path, tiny, device="cuda")
    wav = synthesize_v3(model, "Hello there.", dvec, max_frames=64)
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
