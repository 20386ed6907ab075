"""Dataset-prep tools of the port, keyed as the reference's
python/models_manager.py registers them (``xva_trainer_tpu/tools``' 16 keys).

``TOOL_REGISTRY`` holds the 13 tools ported so far and
``TOOL_SETTINGS_SCHEMA`` their settings forms. The three left need models
the port does not have yet: ``transcribe`` and ``make_srt`` (whisper or
wav2vec2) and ``ass`` (the enhancer). ``get_tool`` raises a ``KeyError``
that names such a tool, so that the server's websocket handler reports it
as a ``tasks_error`` event.
"""
from __future__ import annotations

from .audio_tools import (
    AudioFormatTool,
    AudioNormalizeTool,
    CutPaddingTool,
    NoiseRemovalTool,
    SilenceCutTool,
    SilenceSplitTool,
    SrtSplitTool,
    Wem2OggTool,
)
from .base import BaseTool
from .schema import TOOL_SETTINGS_SCHEMA as _ALL_FORMS
from .speaker_tools import (
    ClusterSpeakersTool,
    DiarizationTool,
    SpeakerClusterSearchTool,
    SpeakerSearchTool,
)
from .text_tools import WerEvaluationTool, wer

# Tool-key registry (reference python/models_manager.py:31-95): the ported tools
TOOL_REGISTRY = {
    "formatting": AudioFormatTool,
    "normalize": AudioNormalizeTool,
    "diarization": DiarizationTool,
    "wem2ogg": Wem2OggTool,
    "cluster_speakers": ClusterSpeakersTool,
    "speaker_search": SpeakerSearchTool,
    "speaker_cluster_search": SpeakerClusterSearchTool,
    "wer_evaluation": WerEvaluationTool,
    "silence_cut": SilenceCutTool,
    "noise_removal": NoiseRemovalTool,
    "silence_split": SilenceSplitTool,
    "cut_padding": CutPaddingTool,
    "srt_split": SrtSplitTool,
}
# their settings forms (``tools/schema.py``), which /toolSettingsSchema serves
TOOL_SETTINGS_SCHEMA = {k: v for k, v in _ALL_FORMS.items() if k in TOOL_REGISTRY}

# the JAX package's 16 keys: the ported ones and the three still to port
JAX_TOOL_KEYS = (
    "formatting", "normalize", "ass", "diarization", "wem2ogg", "cluster_speakers",
    "speaker_search", "speaker_cluster_search", "transcribe", "wer_evaluation",
    "silence_cut", "noise_removal", "silence_split", "cut_padding", "srt_split", "make_srt",
)


def not_ported(key: str) -> KeyError:
    return KeyError(f"tool {key!r} is not ported to the PyTorch package yet")


def get_tool(key: str):
    """The tool class of ``key``; a ``KeyError`` naming it when it is not
    ported yet or is no tool at all."""
    if key in TOOL_REGISTRY:
        return TOOL_REGISTRY[key]
    if key in JAX_TOOL_KEYS:
        raise not_ported(key)
    raise KeyError(f"unknown tool: {key}")


__all__ = ["BaseTool", "TOOL_REGISTRY", "TOOL_SETTINGS_SCHEMA", "JAX_TOOL_KEYS", "get_tool",
           "not_ported", "wer"]
