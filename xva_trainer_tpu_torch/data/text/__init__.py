"""Text front ends of the port: copies of the JAX package's ``data/text``
modules (the v3 rule G2P ``xva_processor``, the multilingual
``preprocessing`` with its G2P backends and the shipped tiers under
``assets/``, the v2 ``processor`` and cleaners, and their tables)."""
from __future__ import annotations

import os

from .xva_processor import XvaTextProcessor


def v3_text_to_ids(lang: str = "en"):
    """The v3 tokenizer, as the JAX package's ``data/text/__init__.py``
    selects it: the multilingual preprocessor when ``XVA_TEXT_DIR`` names a
    directory (read at each call; a list of ids), else the self-contained
    rule G2P (an int32 array)."""
    base_dir = os.environ.get("XVA_TEXT_DIR")
    if base_dir and os.path.isdir(base_dir):
        from .preprocessing import get_text_preprocessor

        tp = get_text_preprocessor(lang, base_dir)
        return lambda text: tp.text_to_sequence(text)[0]
    return XvaTextProcessor().text_to_sequence
