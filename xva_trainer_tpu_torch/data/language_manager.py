"""Multilingual dataset helper, a copy of the JAX package's
``data/language_manager.py`` (reference python/xvapitch/language_manager.py
role): language-id mapping, the language of a priors dataset from its
directory name (the v3 flow tokenizes each priors dataset in its own
language), per-language dataset grouping, inverse-frequency sampling
weights, and JSON persistence."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .xva_dataset import LANG_CODES, language_weights


class LanguageManager:
    """Maps language codes → model ids and groups dataset dirs by language
    (priors layout: ``<lang>_<name>/``)."""

    def __init__(self, language_ids_file_path: str = ""):
        self.language_id_mapping: Dict[str, int] = {
            code: i for i, code in enumerate(LANG_CODES)
        }
        if language_ids_file_path:
            self.load_ids_from_file(language_ids_file_path)

    @property
    def num_languages(self) -> int:
        return len(self.language_id_mapping)

    @property
    def language_names(self) -> List[str]:
        return sorted(self.language_id_mapping)

    def lang_id(self, code: str) -> int:
        return self.language_id_mapping.get(
            (code or "en").lower(), self.language_id_mapping["en"]
        )

    def load_ids_from_file(self, path: str) -> None:
        with open(path, encoding="utf8") as f:
            self.language_id_mapping = {
                k: int(v) for k, v in json.load(f).items()
            }

    def save_ids_to_file(self, path: str) -> None:
        with open(path, "w", encoding="utf8") as f:
            json.dump(self.language_id_mapping, f, indent=2)

    @staticmethod
    def parse_language_from_dir(dataset_dir: str) -> Optional[str]:
        name = os.path.basename(dataset_dir.rstrip("/"))
        if "_" in name and name.split("_")[0] in LANG_CODES:
            return name.split("_")[0]
        return None

    def group_datasets(self, dataset_dirs: Sequence[str]) -> Dict[str, List[str]]:
        groups: Dict[str, List[str]] = {}
        for d in dataset_dirs:
            lang = self.parse_language_from_dir(d) or "en"
            groups.setdefault(lang, []).append(d)
        return groups

    def sampling_weights(self, item_langs: Sequence[str]) -> np.ndarray:
        """Inverse language-frequency weights (reference util.py:403-410)."""
        return language_weights(list(item_langs))
