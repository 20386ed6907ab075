"""Dataset-prep tools of the port, keyed as the reference's
python/models_manager.py registers them: the 16 keys of
``xva_trainer_tpu/tools``.

``TOOL_SETTINGS_SCHEMA`` holds their settings forms (``tools/schema.py``),
which /toolSettingsSchema serves. ``get_tool`` raises a ``KeyError`` for a
key that names no tool, which the server's websocket handler reports as a
``tasks_error`` event.
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
from .schema import TOOL_SETTINGS_SCHEMA
from .speaker_tools import (
    ClusterSpeakersTool,
    DiarizationTool,
    SpeakerClusterSearchTool,
    SpeakerSearchTool,
)
from .text_tools import (
    MakeSrtTool,
    SourceSeparationTool,
    TranscribeTool,
    WerEvaluationTool,
    wer,
)

# Tool-key registry (reference python/models_manager.py:31-95)
TOOL_REGISTRY = {
    "formatting": AudioFormatTool,
    "normalize": AudioNormalizeTool,
    "ass": SourceSeparationTool,
    "diarization": DiarizationTool,
    "wem2ogg": Wem2OggTool,
    "cluster_speakers": ClusterSpeakersTool,
    "speaker_search": SpeakerSearchTool,
    "speaker_cluster_search": SpeakerClusterSearchTool,
    "transcribe": TranscribeTool,
    "wer_evaluation": WerEvaluationTool,
    "silence_cut": SilenceCutTool,
    "noise_removal": NoiseRemovalTool,
    "silence_split": SilenceSplitTool,
    "cut_padding": CutPaddingTool,
    "srt_split": SrtSplitTool,
    "make_srt": MakeSrtTool,
}


def get_tool(key: str):
    """The tool class of ``key``; a ``KeyError`` when it names no tool."""
    if key not in TOOL_REGISTRY:
        raise KeyError(f"unknown tool: {key}")
    return TOOL_REGISTRY[key]


__all__ = ["BaseTool", "TOOL_REGISTRY", "TOOL_SETTINGS_SCHEMA", "get_tool", "wer"]
