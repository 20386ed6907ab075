"""Rule table: flax XVAPitch params -> reference xVAPitch state dict.

The port's own copy of the generator rules of
``xva_trainer_tpu/interop/xvapitch_map.py`` (the port imports nothing of the
JAX package). Torch side: the reference xVAPitch ("big" config: latent 256,
lang-emb 12, text hidden 268, SDP 256, HiFi-GAN decoder 512), whose key
names the port's modules carry. Flax side: the JAX package's XVAPitch.

The generator rules cover every parameter of the shipped
``xVAPitch_5820651.pt`` base checkpoint (and the language classifier's, for
configs with ``mltts_rc``); the discriminator rules cover the VITS
discriminator.
"""
from __future__ import annotations

from typing import List, Tuple

from .mapping import Rule

P = Tuple[str, ...]


def _plain_conv(tkey: str, fpath: P, bias: bool = True) -> List[Rule]:
    rules = [Rule(tkey + ".weight", fpath + ("kernel",), "conv1d")]
    if bias:
        rules.append(Rule(tkey + ".bias", fpath + ("bias",), "id"))
    return rules


def _wn_conv(tkey: str, parent: P, inner: str, wn: str, *, kind="wn_conv1d",
             bias: bool = True) -> List[Rule]:
    # flax nn.WeightNorm names its scale param with a single literal
    # "<layer>/kernel/scale" key under the WeightNorm module
    rules = [
        Rule(
            tkey, parent + (inner, "kernel"), kind,
            scale_path=parent + (wn, f"{inner}/kernel/scale"),
        )
    ]
    if bias:
        rules.append(Rule(tkey + ".bias", parent + (inner, "bias"), "id"))
    return rules


def _layernorm(tkey: str, fpath: P) -> List[Rule]:
    return [
        Rule(tkey + ".gamma", fpath + ("scale",), "id"),
        Rule(tkey + ".beta", fpath + ("bias",), "id"),
    ]


def _wn_rules(tp: str, fp: P, num_layers: int, cond: bool) -> List[Rule]:
    """WaveNet stack (reference wavenet.py WN; flax layers.WN naming:
    cond WeightNorm_0, in_i WeightNorm_{2i+1}, res_skip_i WeightNorm_{2i+2})."""
    rules: List[Rule] = []
    if cond:
        rules += _wn_conv(f"{tp}.cond_layer", fp, "cond_layer", "WeightNorm_0")
    for i in range(num_layers):
        rules += _wn_conv(f"{tp}.in_layers.{i}", fp, f"in_{i}",
                          f"WeightNorm_{2 * i + 1}")
        rules += _wn_conv(f"{tp}.res_skip_layers.{i}", fp, f"res_skip_{i}",
                          f"WeightNorm_{2 * i + 2}")
    return rules


def _transformer_rules(tp: str, fp: P, num_layers: int, *,
                       final_out_1: bool = False) -> List[Rule]:
    """RelativePositionTransformer (reference glow_tts.py:373-465; flax
    layers.RelativePositionTransformer inline naming)."""
    rules: List[Rule] = []
    for i in range(num_layers):
        a = fp + (f"RelativePositionMultiHeadAttention_{i}",)
        ta = f"{tp}.attn_layers.{i}"
        rules += [
            Rule(f"{ta}.emb_rel_k", a + ("emb_rel_k",), "id"),
            Rule(f"{ta}.emb_rel_v", a + ("emb_rel_v",), "id"),
        ]
        for cn in ("conv_q", "conv_k", "conv_v", "conv_o"):
            rules += _plain_conv(f"{ta}.{cn}", a + (cn,))
        rules += _layernorm(f"{tp}.norm_layers_1.{i}",
                            fp + (f"LayerNorm_{2 * i}",))
        f = fp + (f"FeedForwardNetwork_{i}",)
        rules += _plain_conv(f"{tp}.ffn_layers.{i}.conv_1", f + ("Conv_0",))
        rules += _plain_conv(f"{tp}.ffn_layers.{i}.conv_2", f + ("Conv_1",))
        last = (i + 1) == num_layers
        if not (last and final_out_1):
            rules += _layernorm(f"{tp}.norm_layers_2.{i}",
                                fp + (f"LayerNorm_{2 * i + 1}",))
    if final_out_1:
        # hidden != out on the last layer -> reference creates self.proj
        rules += _plain_conv(f"{tp}.proj", fp + ("proj",))
    return rules


def _ddsconv_rules(tp: str, fp: P, num_layers: int = 3) -> List[Rule]:
    """DilatedDepthSeparableConv (reference sdp.py:40-94)."""
    rules: List[Rule] = []
    for i in range(num_layers):
        rules += _plain_conv(f"{tp}.convs_sep.{i}", fp + (f"Conv_{2 * i}",))
        rules += _layernorm(f"{tp}.norms_1.{i}", fp + (f"LayerNorm_{2 * i}",))
        rules += _plain_conv(f"{tp}.convs_1x1.{i}", fp + (f"Conv_{2 * i + 1}",))
        rules += _layernorm(f"{tp}.norms_2.{i}", fp + (f"LayerNorm_{2 * i + 1}",))
    return rules


def _convflow_rules(tp: str, fp: P) -> List[Rule]:
    rules = _plain_conv(f"{tp}.pre", fp + ("pre",))
    rules += _ddsconv_rules(f"{tp}.convs", fp + ("DilatedDepthSeparableConv_0",))
    rules += _plain_conv(f"{tp}.proj", fp + ("proj",))
    return rules


def _sdp_flow_rules(tp: str, fprefix: P, name: str, num_flows: int = 4) -> List[Rule]:
    rules = [
        Rule(f"{tp}.{name}.0.translation", fprefix + (f"{name}_0", "m"), "flat",
             tshape=(2, 1)),
        Rule(f"{tp}.{name}.0.log_scale", fprefix + (f"{name}_0", "logs"), "flat",
             tshape=(2, 1)),
    ]
    for i in range(1, num_flows + 1):
        rules += _convflow_rules(f"{tp}.{name}.{i}", fprefix + (f"{name}_{i}",))
    return rules


def sdp_rules(tp: str = "duration_predictor",
              fp: P = ("duration_predictor",), num_flows: int = 4) -> List[Rule]:
    rules = _plain_conv(f"{tp}.pre", fp + ("pre",))
    rules += _ddsconv_rules(f"{tp}.convs", fp + ("convs",))
    rules += _plain_conv(f"{tp}.proj", fp + ("proj",))
    rules += _sdp_flow_rules(tp, fp, "flows", num_flows)
    rules += _plain_conv(f"{tp}.post_pre", fp + ("post_pre",))
    rules += _ddsconv_rules(f"{tp}.post_convs", fp + ("post_convs",))
    rules += _plain_conv(f"{tp}.post_proj", fp + ("post_proj",))
    rules += _sdp_flow_rules(tp, fp, "post_flows", num_flows)
    rules += _plain_conv(f"{tp}.cond", fp + ("cond",))
    rules += _plain_conv(f"{tp}.cond_lang", fp + ("cond_lang",))
    return rules


def hifigan_decoder_rules(
    tp: str = "waveform_decoder",
    fp: P = ("waveform_decoder",),
    *,
    num_ups: int = 4,
    num_kernels: int = 3,
    num_dilations: int = 3,
    cond: bool = True,
    pre_post_weight_norm: bool = False,
    post_bias: bool = False,
) -> List[Rule]:
    """HiFi-GAN MRF generator (reference python/xvapitch/hifigan.py:160-263 /
    python/hifigan/models.py:81-138; flax models.hifigan.Generator naming:
    Conv_0=pre [maybe wrapped], Conv_1=cond, ConvTranspose_i=ups,
    ResBlock1_m, Conv_last=post)."""
    def j(name: str) -> str:
        return f"{tp}.{name}" if tp else name

    rules: List[Rule] = []
    conv_idx = 0
    if pre_post_weight_norm:
        rules += _wn_conv(j("conv_pre"), fp, f"Conv_{conv_idx}", "WeightNorm_0")
        wn_idx = 1
    else:
        rules += _plain_conv(j("conv_pre"), fp + (f"Conv_{conv_idx}",))
        wn_idx = 0
    conv_idx += 1
    if cond:
        rules += _plain_conv(j("cond_layer"), fp + (f"Conv_{conv_idx}",))
        conv_idx += 1
    for i in range(num_ups):
        rules += _wn_conv(
            j(f"ups.{i}"), fp, f"ConvTranspose_{i}",
            f"WeightNorm_{wn_idx + i}", kind="wn_convT1d",
        )
        for jj in range(num_kernels):
            m = i * num_kernels + jj
            rb = fp + (f"ResBlock1_{m}",)
            for c in range(num_dilations):
                rules += _wn_conv(j(f"resblocks.{m}.convs1.{c}"), rb,
                                  f"Conv_{2 * c}", f"WeightNorm_{2 * c}")
                rules += _wn_conv(j(f"resblocks.{m}.convs2.{c}"), rb,
                                  f"Conv_{2 * c + 1}", f"WeightNorm_{2 * c + 1}")
    if pre_post_weight_norm:
        rules += _wn_conv(j("conv_post"), fp, f"Conv_{conv_idx}",
                          f"WeightNorm_{wn_idx + num_ups}", bias=post_bias)
    else:
        rules += _plain_conv(j("conv_post"), fp + (f"Conv_{conv_idx}",),
                             bias=post_bias)
    return rules


def scale_disc_rules(tp: str, fp: P, num_convs: int) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(num_convs):
        rules += _wn_conv(f"{tp}.convs.{i}", fp, f"Conv_{i}", f"WeightNorm_{i}")
    rules += _wn_conv(f"{tp}.conv_post", fp, f"Conv_{num_convs}",
                      f"WeightNorm_{num_convs}")
    return rules


def period_disc_rules(tp: str, fp: P) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(5):
        rules += _wn_conv(f"{tp}.convs.{i}", fp, f"Conv_{i}", f"WeightNorm_{i}",
                          kind="wn_conv2d")
    rules += _wn_conv(f"{tp}.conv_post", fp, "Conv_5", "WeightNorm_5",
                      kind="wn_conv2d")
    return rules


def vits_disc_rules(tp: str = "disc", fp: P = ()) -> List[Rule]:
    """VitsDiscriminator: nets.0 = v3 scale disc (6 convs), nets.1-5 = MPD.
    ``tp=""`` names the keys of the port's own ``VitsDiscriminator``."""
    pre = f"{tp}." if tp else ""
    rules = scale_disc_rules(f"{pre}nets.0", fp + ("DiscriminatorS_0",), 6)
    for j in range(5):
        rules += period_disc_rules(f"{pre}nets.{j + 1}",
                                   fp + (f"DiscriminatorP_{j}",))
    return rules


def reversal_classifier_rules() -> List[Rule]:
    """The language classifier's two linear layers (flax Dense_0, Dense_1)."""
    rules: List[Rule] = []
    for i in range(2):
        f = ("reversal_classifier", f"Dense_{i}")
        rules += [Rule(f"reversal_classifier._classifier.{i}.weight", f + ("kernel",), "linear"),
                  Rule(f"reversal_classifier._classifier.{i}.bias", f + ("bias",), "id")]
    return rules


def xvapitch_generator_rules(num_ups: int = 4, num_kernels: int = 3,
                             text_layers: int = 10, posterior_layers: int = 16,
                             flow_wn_layers: int = 4, num_flows: int = 4,
                             sdp_flows: int = 4, pitch_layers: int = 3) -> List[Rule]:
    """All generator-side params of the reference xVAPitch ("big", pitch=1).

    The depth arguments parameterize reduced test configs; the shipped model
    uses the defaults."""
    rules: List[Rule] = [Rule("emb_l.weight", ("emb_l", "embedding"), "id")]

    # text encoder
    rules.append(Rule("text_encoder.emb.weight",
                      ("text_encoder", "emb", "embedding"), "id"))
    rules += _transformer_rules("text_encoder.encoder",
                                ("text_encoder", "encoder"), text_layers)
    rules += _plain_conv("text_encoder.proj", ("text_encoder", "proj"))

    # posterior encoder
    pe = ("posterior_encoder",)
    rules += _plain_conv("posterior_encoder.pre", pe + ("pre",))
    rules += _wn_rules("posterior_encoder.enc", pe + ("enc",),
                       posterior_layers, cond=True)
    rules += _plain_conv("posterior_encoder.proj", pe + ("proj",))

    # flow
    for i in range(num_flows):
        f = ("flow", f"flows_{i}")
        rules += _plain_conv(f"flow.flows.{i}.pre", f + ("pre",))
        rules += _wn_rules(f"flow.flows.{i}.enc", f + ("enc",),
                           flow_wn_layers, cond=True)
        rules += _plain_conv(f"flow.flows.{i}.post", f + ("post",))

    # stochastic duration predictor
    rules += sdp_rules(num_flows=sdp_flows)

    # waveform decoder (v3 variant: no pre/post weight norm, no post bias)
    rules += hifigan_decoder_rules(num_ups=num_ups, num_kernels=num_kernels)

    # pitch predictor + pitch embedding
    rules += _transformer_rules(
        "pitch_predictor.encoder",
        ("pitch_predictor", "RelativePositionTransformer_0"), pitch_layers,
        final_out_1=True,
    )
    rules += _plain_conv("pitch_emb", ("pitch_emb",))
    return rules


def rules_for_config(cfg) -> List[Rule]:
    """Generator rules matching an XVAPitchConfig instance."""
    extra = reversal_classifier_rules() if cfg.mltts_rc else []
    return extra + xvapitch_generator_rules(
        num_ups=len(cfg.upsample_rates),
        num_kernels=len(cfg.resblock_kernel_sizes),
        text_layers=cfg.text_layers,
        posterior_layers=cfg.posterior_layers,
        flow_wn_layers=cfg.flow_wn_layers,
        num_flows=cfg.num_flows,
        sdp_flows=cfg.sdp_flows,
        pitch_layers=cfg.pitch_layers,
    )


# torch keys present in the reference state dict but unused by its forward
# (the last norm_layers_2 of the out_channels==1 pitch transformer) — emitted
# as defaults on export so the key set matches exactly.
def unused_torch_defaults(pitch_layers: int = 3):
    i = pitch_layers - 1
    return {
        f"pitch_predictor.encoder.norm_layers_2.{i}.gamma": ("ones", (1,)),
        f"pitch_predictor.encoder.norm_layers_2.{i}.beta": ("zeros", (1,)),
    }


UNUSED_TORCH_DEFAULTS = unused_torch_defaults()
