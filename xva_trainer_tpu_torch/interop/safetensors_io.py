"""Read a ``.safetensors`` file without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, offsets relative to the end of the header), then the raw
little-endian tensor data. ``import-whisper`` reads a HuggingFace
``model.safetensors`` with it.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a ``.safetensors`` file, on the CPU, each tensor
    owning its memory."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, which is not read")
        begin, end = meta["data_offsets"]
        dtype = DTYPES[meta["dtype"]]
        if end > begin:
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        out[name] = t.reshape(meta["shape"])
    return out
