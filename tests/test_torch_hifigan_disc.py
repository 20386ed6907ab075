"""Port parity: the v2 HiFi-GAN discriminator (flax's spectral norm, the
average pool, MPD, MSD and ``HifiganDiscriminator``) and the ``g_``/``do_``
warm-start loaders, against the JAX package on the same seeded weights and
inputs. Tolerances: scores and feature maps 1e-5 max abs (fp32), the
spectral norm's ``u`` 1e-6 max abs, loaded forwards 1e-5 max abs."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_v3_common import _seeded
from xva_trainer_tpu.interop import hifigan_map as jax_hifigan_map
from xva_trainer_tpu.interop import pretrained as jax_pretrained
from xva_trainer_tpu.interop.xvapitch_map import period_disc_rules as jax_period_disc_rules
from xva_trainer_tpu.interop.xvapitch_map import scale_disc_rules as jax_scale_disc_rules
from xva_trainer_tpu.models.hifigan import Generator as JaxGenerator
from xva_trainer_tpu.models.hifigan import HifiganConfig as JaxHifiganConfig
from xva_trainer_tpu.models.hifigan import HifiganDiscriminator as JaxHifiganDiscriminator
from xva_trainer_tpu.models.hifigan.models import _avg_pool as jax_avg_pool
from xva_trainer_tpu_torch.interop.convert import (hifigan_v2_disc_state_dict,
                                                   hifigan_v2_state_dict, ups_to_reference)
from xva_trainer_tpu_torch.interop.hifigan_map import (SPECTRAL_CONVS, v2_mpd_rules,
                                                       v2_msd_wn_rules)
from xva_trainer_tpu_torch.interop.pretrained import (load_hifigan_discriminators,
                                                      load_hifigan_generator)
from xva_trainer_tpu_torch.models.hifigan import (Generator, HifiganConfig,
                                                  HifiganDiscriminator, SpectralNormConv1d)
from xva_trainer_tpu_torch.models.hifigan.models import _avg_pool

PERIODS, SCALES, T = (2, 3), 2, 2048
# the generator of the loader test: the reference's structure (4 upsamplings,
# 3 resblock kernels, as JAX's loader expects), 16 channels wide
GEN_KW = dict(upsample_initial_channel=16)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _channels_first(a: np.ndarray, like: torch.Tensor) -> np.ndarray:
    """A flax activation (B, T, C) or (B, T/p, p, C) in the port's layout."""
    if a.ndim == 3:
        a = a.transpose(0, 2, 1)
    elif a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    return a.reshape(tuple(like.shape))


def _max_err(jax_out, port_out) -> float:
    return max(float(np.abs(_channels_first(a, b) - b.numpy()).max())
               for a, b in zip(_leaves(jax_out), jax.tree_util.tree_leaves(port_out)))


@pytest.fixture(scope="module")
def disc_case():
    """Seeded variables of a JAX HifiganDiscriminator(periods=(2, 3),
    n_scales=2) (shapes traced, not compiled) and a real and a generated
    batch of 2 × 2048 samples."""
    jd = JaxHifiganDiscriminator(periods=PERIODS, n_scales=SCALES)
    x = jnp.zeros((1, T, 1))
    variables = _seeded(jax.eval_shape(jd.init, jax.random.PRNGKey(0), x, x), 3)
    rng = np.random.default_rng(4)
    y = np.clip(0.3 * rng.standard_normal((2, T, 1)), -1, 1).astype(np.float32)
    y_hat = np.clip(0.3 * rng.standard_normal((2, T, 1)), -1, 1).astype(np.float32)
    return jd, variables, y, y_hat


def _port_disc(variables) -> HifiganDiscriminator:
    disc = HifiganDiscriminator(PERIODS, SCALES)
    disc.load_state_dict(hifigan_v2_disc_state_dict(variables["params"],
                                                    variables["batch_stats"]), strict=True)
    return disc


@pytest.mark.parametrize("spec", [(64, 41, 4, 16, 20), (128, 15, 1, 1, 7), (1, 3, 1, 1, 1)],
                         ids=["grouped_strided", "first", "post"])
def test_spectral_norm_matches_flax(spec):
    """One conv under flax's nn.SpectralNorm and under the port's: the
    output, then ``u`` after one and after two updating calls; a call with
    update_stats False stores nothing and computes the same output."""
    ch, k, s, g, p = spec
    cin = 32 if g > 1 else (16 if ch == 1 else 1)

    class Wrapped(fnn.Module):
        @fnn.compact
        def __call__(self, x, update_stats):
            conv = fnn.Conv(ch, (k,), strides=(s,), feature_group_count=g, padding=((p, p),))
            return fnn.SpectralNorm(conv)(x, update_stats=update_stats)

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 300, cin)).astype(np.float32)
    m = Wrapped()
    v = _seeded(jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.asarray(x), False)), 5)
    u0 = v["batch_stats"]["SpectralNorm_0"]["Conv_0/kernel/u"]
    port = SpectralNormConv1d(cin, ch, k, s, groups=g, padding=p)
    with torch.no_grad():
        port.weight_orig.copy_(torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(2, 1, 0)))
        port.bias.copy_(torch.from_numpy(v["params"]["Conv_0"]["bias"]))
        port.weight_u.copy_(torch.from_numpy(u0.reshape(-1)))
    xt = torch.from_numpy(x.transpose(0, 2, 1))

    stats = v["batch_stats"]
    for call in range(2):
        out, new = m.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x), True,
                           mutable=["batch_stats"])
        with torch.no_grad():
            ours = port(xt, update_stats=True)
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
        u_jax = stats["SpectralNorm_0"]["Conv_0/kernel/u"].reshape(-1)
        assert np.abs(ours.numpy().transpose(0, 2, 1) - np.asarray(out)).max() < 1e-5, call
        assert np.abs(port.weight_u.numpy() - u_jax).max() < 1e-6, call
    out, new = m.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x), False,
                       mutable=["batch_stats"])
    u_before = port.weight_u.clone()
    with torch.no_grad():
        ours = port(xt, update_stats=False)
    assert torch.equal(port.weight_u, u_before)
    np.testing.assert_array_equal(new["batch_stats"]["SpectralNorm_0"]["Conv_0/kernel/u"],
                                  stats["SpectralNorm_0"]["Conv_0/kernel/u"])
    assert np.abs(ours.numpy().transpose(0, 2, 1) - np.asarray(out)).max() < 1e-5


def test_spectral_norm_differs_from_torchs():
    """torch's own spectral norm computes another function: in eval mode it
    runs no power iteration, so from the same u its output differs from
    flax's, which iterates on every call."""
    torch.manual_seed(0)
    ours = SpectralNormConv1d(8, 16, 5, padding=2)
    ref = torch.nn.utils.spectral_norm(torch.nn.Conv1d(8, 16, 5, padding=2)).eval()
    with torch.no_grad():
        ref.weight_orig.copy_(ours.weight_orig)
        ref.bias.copy_(ours.bias)
        ref.weight_u.copy_(ours.weight_u)
        ref.weight_v.copy_(ours.weight_v)
        x = torch.randn(1, 8, 40)
        assert (ours(x) - ref(x)).abs().max() > 1e-3


@pytest.mark.parametrize("length", [2048, 1025, 7, 1])
def test_avg_pool_matches_flax(length):
    """``AvgPool1d(4, 2, padding=2)`` is flax's avg_pool(4, 2, padding 2),
    padded zeros counted: the same length T//2 + 1 and values."""
    x = np.random.default_rng(length).standard_normal((2, length, 3)).astype(np.float32)
    ref = np.asarray(jax_avg_pool(jnp.asarray(x)))
    with torch.no_grad():
        ours = _avg_pool()(torch.from_numpy(x.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    assert ours.shape == ref.shape == (2, length // 2 + 1, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("update", [False, True], ids=["frozen_stats", "update_sn_stats"])
def test_discriminator_matches_jax(disc_case, update):
    """HifiganDiscriminator(periods=(2, 3), n_scales=2) on 2048 samples:
    every score and feature map within 1e-5, MPD first; with
    ``update_sn_stats`` the stored u (two iterations a call: the real pass,
    then the generated pass from its u) within 1e-6 of JAX's batch_stats,
    without it unchanged."""
    jd, variables, y, y_hat = disc_case
    out, new = jd.apply(variables, jnp.asarray(y), jnp.asarray(y_hat), update_sn_stats=update,
                        mutable=["batch_stats"])
    disc = _port_disc(variables)
    u_before = {k: v.clone() for k, v in disc.state_dict().items() if k.endswith("weight_u")}
    with torch.no_grad():
        ours = disc(torch.from_numpy(y.transpose(0, 2, 1)),
                    torch.from_numpy(y_hat.transpose(0, 2, 1)), update_sn_stats=update)
    assert [len(o) for o in ours] == [len(PERIODS) + SCALES] * 4
    assert _max_err(out, ours) < 1e-5
    new_sd = hifigan_v2_disc_state_dict(variables["params"],
                                        jax.tree_util.tree_map(np.asarray, new["batch_stats"]))
    sd = disc.state_dict()
    assert len(u_before) == len(SPECTRAL_CONVS)
    for k, before in u_before.items():
        assert float((sd[k] - new_sd[k]).abs().max()) < 1e-6, k
        assert torch.equal(sd[k], before) != update, k


def test_state_dict_keys_are_the_references():
    """The full discriminator's state dict holds the reference's ``do_`` keys:
    the MPD and weight-normed MSD rules' and MSD disc 0's ``weight_orig``,
    ``bias``, ``weight_u`` and ``weight_v``."""
    rule_keys = set()
    for r in v2_mpd_rules() + v2_msd_wn_rules():
        rule_keys |= ({r.torch_key + ".weight_g", r.torch_key + ".weight_v"}
                      if r.kind.startswith("wn_") else {r.torch_key})
    jax_keys = set()
    for r in jax_hifigan_map.v2_mpd_rules() + jax_hifigan_map.v2_msd_wn_rules():
        jax_keys |= ({r.torch_key + ".weight_g", r.torch_key + ".weight_v"}
                     if r.kind.startswith("wn_") else {r.torch_key})
    spectral = {f"msd.discriminators.0.{n}.{p}" for n in SPECTRAL_CONVS
                for p in ("weight_orig", "bias", "weight_u", "weight_v")}
    assert rule_keys == jax_keys
    assert set(HifiganDiscriminator().state_dict()) == rule_keys | spectral


def _reduced_jax_rules(monkeypatch):
    """JAX's ``do_`` loader at the reduced discriminator (2 periods, 2
    scales): its rule tables cut to the reduced counts, for this test only."""

    def mpd(tp="mpd", fp=("MultiPeriodDiscriminator_0",)):
        return sum((jax_period_disc_rules(f"{tp}.discriminators.{j}", fp + (f"DiscriminatorP_{j}",))
                    for j in range(len(PERIODS))), [])

    def msd(tp="msd", fp=("MultiScaleDiscriminator_0",)):
        return sum((jax_scale_disc_rules(f"{tp}.discriminators.{j}", fp + (f"DiscriminatorS_{j}",), 7)
                    for j in range(1, SCALES)), [])

    monkeypatch.setattr(jax_hifigan_map, "v2_mpd_rules", mpd)
    monkeypatch.setattr(jax_hifigan_map, "v2_msd_wn_rules", msd)


def test_load_hifigan_discriminators_matches_jax(disc_case, tmp_path, monkeypatch):
    """A reference-layout ``do_`` file written with torch.save from seeded
    tensors (MSD disc 0 as weight_orig/weight_u/weight_v): the port's loader
    and JAX's give the same forwards (1e-5; both iterate once more from the
    file's u) and the same ``meta``; the port's loaded tensors are the
    file's."""
    jd, variables, y, y_hat = disc_case
    src = _port_disc(variables)
    with torch.no_grad():  # a v that is not the one JAX would compute from u
        for m in src.msd.discriminators[0].modules():
            if isinstance(m, SpectralNormConv1d):
                m.weight_v.normal_()
    path = tmp_path / "do_00000005"
    torch.save({"mpd": src.mpd.state_dict(), "msd": src.msd.state_dict(), "steps": 7,
                "epoch": 2, "optim_g": {}, "optim_d": {}}, path)
    _reduced_jax_rules(monkeypatch)
    j_vars, j_meta = jax_pretrained.load_hifigan_discriminators(str(path))
    disc = HifiganDiscriminator(PERIODS, SCALES)
    meta = load_hifigan_discriminators(str(path), disc)
    assert meta == j_meta == {"steps": 7, "epoch": 2}
    for k, v in src.state_dict().items():
        assert torch.equal(disc.state_dict()[k], v), k
    out, _ = jd.apply(j_vars, jnp.asarray(y), jnp.asarray(y_hat), update_sn_stats=False,
                      mutable=["batch_stats"])
    with torch.no_grad():
        ours = disc(torch.from_numpy(y.transpose(0, 2, 1)), torch.from_numpy(y_hat.transpose(0, 2, 1)))
    assert _max_err(out, ours) < 1e-5


def _filter_norms(sd: dict) -> dict:
    """Each weight-normed layer's effective-weight norm per output filter
    (``weight_g``'s axis), by layer name."""
    out = {}
    for k, g in sd.items():
        if k.endswith("weight_g"):
            v = sd[k[:-1] + "v"].double()
            dim = max(range(g.dim()), key=lambda i: g.shape[i])
            w = torch._weight_norm(v, g.double(), dim)
            out[k[:-len(".weight_g")]] = w.pow(2).sum([i for i in range(w.dim()) if i != dim]).sqrt()
    return out


def test_generator_initial_filter_norms_match_flax():
    """The port's fresh generator starts from the filter norms of a JAX
    ``init`` (flax's ``WeightNorm`` scales start at 1, so every filter has
    unit norm), layer by layer, within 1e-6. One resblock kernel keeps the
    JAX init's compile short."""
    kw = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),))
    params = jax.jit(JaxGenerator(JaxHifiganConfig(**kw)).init)(jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 8, 80)))
    carried = Generator(HifiganConfig(**kw))
    carried.load_state_dict(hifigan_v2_state_dict(jax.device_get(params), carried.cfg),
                            strict=True)
    torch.manual_seed(0)
    want, have = _filter_norms(carried.state_dict()), _filter_norms(
        Generator(HifiganConfig(**kw)).state_dict())
    assert want.keys() == have.keys() and len(want) == 2 + 4 + 4 * 4
    for k in want:
        assert want[k].shape == have[k].shape, k
        assert float((want[k] - have[k]).abs().max()) < 1e-6, k


def test_load_hifigan_generator_matches_jax(tmp_path):
    """A reference ``g_`` file ({'generator': sd}, ``ups`` weight-normed per
    input channel) written from seeded tensors: the port's loader and JAX's
    give the same waveform within 1e-5."""
    jcfg = JaxHifiganConfig(**GEN_KW)
    mel = np.random.default_rng(8).standard_normal((1, 8, 80)).astype(np.float32)
    jg = JaxGenerator(jcfg)
    params = _seeded(jax.eval_shape(jg.init, jax.random.PRNGKey(0), jnp.asarray(mel)), 9)
    src = Generator(HifiganConfig(**GEN_KW))
    src.load_state_dict(hifigan_v2_state_dict(params, src.cfg), strict=True)
    ref_sd = ups_to_reference(src.state_dict())
    assert all(v.shape[1] == 1 for k, v in ref_sd.items() if ".ups." in k and k.endswith("_g"))
    path = tmp_path / "g_00000005"
    torch.save({"generator": ref_sd}, path)
    j_params = jax_pretrained.load_hifigan_generator(str(path))
    gen = Generator(HifiganConfig(**GEN_KW))
    load_hifigan_generator(str(path), gen)
    ref = np.asarray(jg.apply(j_params, jnp.asarray(mel)))[..., 0]
    with torch.no_grad():
        ours = gen(torch.from_numpy(mel.transpose(0, 2, 1)))[:, 0].numpy()
    assert ours.shape == ref.shape == (1, 8 * 256)
    assert np.abs(ref).max() > 1e-2
    assert np.abs(ours - ref).max() < 1e-5
