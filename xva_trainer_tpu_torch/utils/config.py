"""Unified typed-config overlays.

The port's copy of ``xva_trainer_tpu/utils/config.py``. Every trainer keeps
one typed dataclass, and this module applies overlays in a fixed
precedence:

    dataclass defaults  <  JSON file  <  server/UI message dict  <  CLI args

Unknown keys are reported (not silently dropped) so UI/config typos surface.
The port's ``XvaTrainConfig`` has no ``fused_gd`` (an XLA program layout), so
a message that carries it reports it as unknown.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, target_type) -> Any:
    """Best-effort coercion of overlay values to the field's type."""
    if target_type in (int, float, bool, str) and value is not None:
        if target_type is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        try:
            return target_type(value)
        except (TypeError, ValueError):
            return value
    return value


def _field_types(cfg) -> Dict[str, type]:
    """Resolve declared field types to real classes. Under PEP 563
    (``from __future__ import annotations``) dataclasses.fields().type is a
    STRING, so get_type_hints is required; Optional[X] resolves to X."""
    import typing

    out: Dict[str, type] = {}
    try:
        hints = typing.get_type_hints(type(cfg))
    except Exception:
        hints = {}
    for name, hint in hints.items():
        if isinstance(hint, type):
            out[name] = hint
            continue
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1 and isinstance(args[0], type):
            out[name] = args[0]  # Optional[X] → X
    return out


def overlay(cfg: T, *layers: Optional[Dict[str, Any]]) -> Tuple[T, List[str]]:
    """Apply overlay dicts onto a dataclass instance (later layers win).

    Returns (new_config, unknown_keys)."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"{type(cfg)} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    types = _field_types(cfg)
    values: Dict[str, Any] = {}
    unknown: List[str] = []
    for layer in layers:
        if not layer:
            continue
        for k, v in layer.items():
            if k in fields:
                tt = types.get(k)
                if tt is None and getattr(cfg, k) is not None:
                    tt = type(getattr(cfg, k))
                values[k] = _coerce(v, tt)
            else:
                unknown.append(k)
    return dataclasses.replace(cfg, **values), unknown


def load_json_layer(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if path and os.path.exists(path):
        with open(path, encoding="utf8") as f:
            return json.load(f)
    return None


def cli_layer(pairs: Sequence[str]) -> Dict[str, Any]:
    """Parse ``key=value`` CLI overrides."""
    out: Dict[str, Any] = {}
    for p in pairs:
        if "=" in p:
            k, v = p.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def build_config(
    cls: Type[T],
    json_path: Optional[str] = None,
    message: Optional[Dict[str, Any]] = None,
    cli: Sequence[str] = (),
    **base_kwargs,
) -> Tuple[T, List[str]]:
    """defaults < json < message < cli. Returns (config, unknown_keys)."""
    cfg = cls(**base_kwargs)
    return overlay(cfg, load_json_layer(json_path), message, cli_layer(cli))
