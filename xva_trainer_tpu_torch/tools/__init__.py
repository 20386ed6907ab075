"""Dataset-prep tools of the port, keyed as the reference's
python/models_manager.py registers them (``xva_trainer_tpu/tools``' 16 keys).

``TOOL_REGISTRY`` holds the tools ported so far (none yet) and
``TOOL_SETTINGS_SCHEMA`` their settings forms. ``get_tool``
raises a ``KeyError`` that names a tool the JAX package has and the port
does not have yet, so that the server's websocket handler reports it as a
``tasks_error`` event.
"""
from __future__ import annotations

# Tool-key registry (reference python/models_manager.py:31-95): the ported tools
TOOL_REGISTRY: dict = {}
# their settings forms (xva_trainer_tpu/tools/schema.py's TOOL_SETTINGS_SCHEMA
# entries), which /toolSettingsSchema serves
TOOL_SETTINGS_SCHEMA: dict = {}

# the JAX package's keys, each waiting for its port
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
