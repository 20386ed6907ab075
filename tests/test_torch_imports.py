"""Import hygiene of the PyTorch port: it imports torch, numpy and scipy, and
never JAX, anything of the JAX package ``xva_trainer_tpu``, scikit-learn,
``websockets``, ``safetensors`` or ``transformers`` (none of which the
card's machine has; the task server's websocket is the stdlib ``app/ws.py``,
and ``interop/safetensors_io.py`` reads the safetensors format)."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import xva_trainer_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xva_trainer_tpu", "sklearn",
             "websockets", "safetensors", "transformers")
SOURCES = ["chip_smoke.py"] + sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "xva_trainer_tpu_torch"))
    for f in files if f.endswith(".py"))


def _port_modules():
    pkg = xva_trainer_tpu_torch
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                   pkg.__name__ + ".")]


def test_port_imports_no_jax():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter: no JAX module, no module of the JAX package, no
    scikit-learn, no ``websockets``, no ``safetensors`` and no ``transformers``
    is loaded."""
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.startswith(('jax', 'flax', 'optax', "
        "'orbax', 'sklearn', 'websockets', 'safetensors', 'transformers')) "
        "or k == 'xva_trainer_tpu' "
        "or k.startswith('xva_trainer_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(mods) > 20
    for m in ("app.server", "app.manager", "app.ws", "utils.config", "utils.telemetry",
              "train.profiler", "tools", "cli", "demo", "models.whisper", "models.wav2vec2",
              "models.enhance", "interop.whisper_map", "interop.wav2vec2_map",
              "interop.safetensors_io", "parallel.distributed", "parallel.mesh", "parallel.tp",
              "parallel.draws", "models.waveglow", "models.waveglow.model", "ops.ssim"):
        assert "xva_trainer_tpu_torch." + m in mods


@pytest.mark.parametrize("path", SOURCES)
def test_port_sources_name_no_jax(path):
    """No import statement in the port's sources or chip_smoke.py names JAX,
    the JAX package or another forbidden package, at any depth of the file."""
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)
