"""Port parity of the v3 export and warm start against the JAX package.

- The port's ``xvapitch_state_dict`` of JAX parameters carried into the port
  (``interop/convert.py::train_state_dicts``) has the key set and dtypes of
  JAX's ``xvapitch_state_dict`` of the same parameters, and each value
  within 1 fp16 ulp (both re-split every weight-norm pair in float64 and
  round to fp16; a float32 rounding apart may fall either side of an fp16
  tie). The metadata JSON and ``model_config.json`` are equal to JAX's.
- A ``.pt`` written by JAX's ``export_xvapitch_v3`` and loaded by the port's
  ``load_xvapitch_base`` gives the effective weights JAX's
  ``load_xvapitch_base`` gives (within 1e-6 of each tensor's max abs: both
  read the same fp16 file, and differ by float32 rounding of w = g·v/||v||).
- The port's export, read back by JAX's ``load_xvapitch_base`` (its
  torch-free reader), gives the port model's effective weights within 1e-3
  of each tensor's max abs (fp16 has an 11-bit significand: v and g each
  round by up to 2^-11 relative).
- ``ScalarWriter`` writes the same event bytes as JAX's for the same
  scalars and wall time.

JAX's loader reads the shipped base's key set, so the warm-start tests run
at the reference's full depths with narrow widths (``DEEP``); the export's
own parity runs at the tiny config of tests/test_fused_gd.py. No JAX program
is compiled: parameters come from shapes traced with ``jax.eval_shape``.
"""
import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch
from torch_v3_common import (JCFG, RNGS, SEG, TCFG, _seeded, batch_np, jax_batch, port_models,
                             seeded_params)

from xva_trainer_tpu.data import xva_dataset as jxd
from xva_trainer_tpu.interop.pretrained import load_xvapitch_base as jax_load_xvapitch_base
from xva_trainer_tpu.models.xvapitch import VitsDiscriminator as JaxVitsDiscriminator
from xva_trainer_tpu.models.xvapitch import XVAPitch as JaxXVAPitch
from xva_trainer_tpu.models.xvapitch import XVAPitchConfig as JaxXVAPitchConfig
from xva_trainer_tpu.parallel.mesh import make_mesh
from xva_trainer_tpu.train import checkpoints as jax_checkpoints
from xva_trainer_tpu.train import tb_writer as jax_tb
from xva_trainer_tpu.train import xvapitch_trainer as jxt
from xva_trainer_tpu.train.xvapitch_trainer import _materialize_spec
from xva_trainer_tpu_torch.data import xva_dataset as pxd
from xva_trainer_tpu_torch.interop.convert import train_state_dicts
from xva_trainer_tpu_torch.interop.pretrained import load_xvapitch_base
from xva_trainer_tpu_torch.models.xvapitch import VitsDiscriminator, XVAPitch, XVAPitchConfig
from xva_trainer_tpu_torch.train import checkpoints, tb_writer
from xva_trainer_tpu_torch.train import xvapitch_trainer as pxt
from xva_trainer_tpu_torch.train.checkpoints import _weight_norm_dims

# the reference's depths (the shipped base's key set), narrow
DEEP_KW = dict(big=False, upsample_initial_channel=32, spec_segment_size=8)
JDEEP, DEEP = JaxXVAPitchConfig(**DEEP_KW), XVAPitchConfig(**DEEP_KW)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _seeded_deep(seed=0):
    """Seeded JAX (generator, discriminator) parameters at ``JDEEP``."""
    b = jax_batch(batch_np())
    lin, wav = _materialize_spec(b, hop=256)
    g = jax.eval_shape(JaxXVAPitch(JDEEP).init, RNGS, b["tokens"], b["tlens"], lin, b["slens"],
                       b["pitch"], b["energy"], wav, b["dvec"], b["lang"])
    seg = jax.numpy.zeros((2, SEG, 1))
    d = jax.eval_shape(JaxVitsDiscriminator().init, jax.random.PRNGKey(9), seg, seg)
    return _seeded(g, seed), _seeded(d, seed + 1)


def _port_from_jax(g_params, d_params, cfg):
    g_sd, d_sd = train_state_dicts(g_params, d_params, cfg)
    model, disc = XVAPitch(cfg), VitsDiscriminator()
    model.load_state_dict(g_sd, strict=True)
    disc.load_state_dict(d_sd, strict=True)
    return model, disc


@torch.no_grad()
def effective(module):
    """Every parameter as the forward uses it, in float64: each weight-norm
    pair combined (g·v/||v|| over its dim), the rest as they are."""
    out = {}
    wn = _weight_norm_dims(module)
    sd = module.state_dict()
    for base, dim in wn.items():
        g, v = sd[base + "_g"].double(), sd[base + "_v"].double()
        dims = [d for d in range(v.dim()) if d != dim]
        out[base] = v / torch.sqrt((v * v).sum(dim=dims, keepdim=True)) * g
    for k, v in sd.items():
        if not any(k == b + "_g" or k == b + "_v" for b in wn):
            out[k] = v.double()
    return out


def assert_effective_close(ours, ref, rel):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        scale = max(float(ref[k].abs().max()), 1e-30)
        assert float((ours[k] - ref[k]).abs().max()) <= rel * scale, k


def assert_fp16_within_one_ulp(ours, ref):
    assert sorted(ours) == sorted(ref)
    exact = 0
    for k, r in ref.items():
        o = ours[k].numpy()
        assert o.dtype == r.dtype and o.shape == r.shape, k
        if o.dtype != np.float16:
            assert np.array_equal(o, r), k
            continue
        ulp = np.spacing(np.maximum(np.abs(o), np.abs(r)).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(o.astype(np.float32) - r.astype(np.float32)) <= ulp), k
        exact += int(np.array_equal(o, r))
    return exact


@pytest.fixture(scope="module")
def tiny():
    """Seeded JAX parameters at the tiny config (weight-norm scales away from
    the kernels' norms), and the port's models carrying them."""
    g_params, d_params = seeded_params(0)
    return (g_params, d_params) + port_models(g_params, d_params)


def test_export_equals_jax_state_dict(tiny):
    """The port's export of the carried parameters against JAX's export of
    the same parameters."""
    g_params, d_params, model, disc = tiny
    ref = jax_checkpoints.xvapitch_state_dict(g_params, d_params, model_cfg=JCFG)
    ours = checkpoints.xvapitch_state_dict(model, disc)
    assert sorted(ours) == sorted(ref)
    assert any(k.startswith("disc.") for k in ours)
    assert all(v.dtype == torch.float16 for v in ours.values())
    exact = assert_fp16_within_one_ulp(ours, ref)
    assert exact >= 0.95 * len(ref)
    # the decoder's ups in the reference layout: g per input channel
    ups_g = [k for k in ours if ".ups." in k and k.endswith("weight_g")]
    assert ups_g and all(ours[k].shape[1:] == (1, 1) and ours[k].shape[0] > 1 for k in ups_g)


def test_export_files_and_model_config_equal_jax(tiny, tmp_path):
    """``export_xvapitch_v3``'s metadata JSON, and the trainers'
    ``model_config.json``, equal JAX's byte for byte; the ``.pt``s hold the
    same state dict."""
    g_params, d_params, model, disc = tiny
    emb = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    others = [[0.25, -0.5], [1.0, 2.0]]
    for sub in ("jax", "port"):
        os.makedirs(tmp_path / sub)
    jax_checkpoints.export_xvapitch_v3(g_params["params"], str(tmp_path / "jax" / "v.pt"),
                                       "voice", lang="de", base_emb=emb, other_embs=others,
                                       d_params=d_params["params"], model_cfg=JCFG,
                                       lang_capabilities=["de", "en"])
    checkpoints.export_xvapitch_v3(model, str(tmp_path / "port" / "v.pt"), "voice", lang="de",
                                   base_emb=emb, other_embs=others, disc=disc,
                                   lang_capabilities=["de", "en"])
    assert (tmp_path / "port" / "v.json").read_bytes() == (tmp_path / "jax" / "v.json").read_bytes()
    ours = torch.load(tmp_path / "port" / "v.pt", weights_only=True)
    ref = torch.load(tmp_path / "jax" / "v.pt", weights_only=True)
    assert_fp16_within_one_ulp(ours, {k: v.numpy() for k, v in ref.items()})

    dvec = np.zeros(512, np.float32)
    jxt.XVAPitchTrainer(jxd.XvaBatcher([], batch_size=2, d_vector=dvec),
                        jxt.XvaTrainConfig(output_dir=str(tmp_path / "jt")), JCFG,
                        mesh=make_mesh(n_data=1))
    pxt.XVAPitchTrainer(pxd.XvaBatcher([], batch_size=2, d_vector=dvec),
                        pxt.XvaTrainConfig(output_dir=str(tmp_path / "pt")), TCFG, device="cpu")
    assert (tmp_path / "pt" / "model_config.json").read_bytes() == \
        (tmp_path / "jt" / "model_config.json").read_bytes()
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)


@pytest.fixture(scope="module")
def deep():
    g_params, d_params = _seeded_deep(0)
    return g_params, d_params


def test_warm_start_from_a_jax_export_equals_jax_load(deep, tmp_path):
    """JAX's ``export_xvapitch_v3`` of seeded parameters at the reference's
    depths; the port's warm start from that file against JAX's warm start
    from it, effective weight for effective weight, the discriminator
    included."""
    g_params, d_params = deep
    path = str(tmp_path / "base.pt")
    jax_checkpoints.export_xvapitch_v3(g_params["params"], path, "base",
                                       d_params=d_params["params"], model_cfg=JDEEP)
    jg, jd = jax_load_xvapitch_base(path)
    ref_model, ref_disc = _port_from_jax(jg, jd, DEEP)
    model, disc = XVAPitch(DEEP), VitsDiscriminator()
    assert load_xvapitch_base(path, model, disc)
    assert_effective_close(effective(model), effective(ref_model), 1e-6)
    assert_effective_close(effective(disc), effective(ref_disc), 1e-6)
    # and both are the exported parameters', to fp16 rounding
    src_model, _ = _port_from_jax(g_params, d_params, DEEP)
    assert_effective_close(effective(model), effective(src_model), 1e-3)


def test_port_export_read_by_jax_loader(deep, tmp_path):
    """The port's export, read back by JAX's torch-free loader, gives the
    port model's effective weights to fp16 rounding; the two packages'
    loaders agree on it to float32 rounding."""
    model, disc = _port_from_jax(*deep, DEEP)
    path = str(tmp_path / "voice.pt")
    checkpoints.export_xvapitch_v3(model, path, "voice", disc=disc)
    jg, jd = jax_load_xvapitch_base(path)
    back_model, back_disc = _port_from_jax(jg, jd, DEEP)
    assert_effective_close(effective(back_model), effective(model), 1e-3)
    assert_effective_close(effective(back_disc), effective(disc), 1e-3)
    ours_model, ours_disc = XVAPitch(DEEP), VitsDiscriminator()
    assert load_xvapitch_base(path, ours_model, ours_disc)
    assert_effective_close(effective(ours_model), effective(back_model), 1e-6)
    assert_effective_close(effective(ours_disc), effective(back_disc), 1e-6)


@pytest.mark.parametrize("wrapper", [None, "model", "state_dict", "generator"])
def test_warm_start_unwraps_and_keeps_an_absent_discriminator(tiny, wrapper, tmp_path):
    """A base under ``model``/``state_dict``/``generator`` (or bare) loads
    the same; without ``disc.*`` keys the discriminator (here a stand-in)
    stays as it was."""
    model = tiny[2]
    sd = checkpoints.xvapitch_state_dict(model)  # no discriminator
    path = str(tmp_path / "base.pt")
    torch.save(sd if wrapper is None else {wrapper: sd, "step": 7}, path)
    fresh, fresh_disc = XVAPitch(TCFG), torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in fresh_disc.state_dict().items()}
    assert not load_xvapitch_base(path, fresh, fresh_disc)
    assert_effective_close(effective(fresh), effective(model), 1e-3)
    assert all(torch.equal(v, before[k]) for k, v in fresh_disc.state_dict().items())


def test_scalar_writer_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_780_000_000.25)
    scalars = [("loss/loss", 12.5, 21), ("loss/disc", 2.75, 21), ("meta/frames/s", 91900.0, 21),
               ("loss/mel", -0.125, 42)]
    files = []
    for mod, sub in ((jax_tb, "jax"), (tb_writer, "port")):
        w = mod.ScalarWriter(str(tmp_path / sub), flush_secs=30.0)
        for tag, v, step in scalars:
            w.add_scalar(tag, v, step)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        ref, ours = a.read(), b.read()
    assert ours == ref and len(ref) > 100
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
