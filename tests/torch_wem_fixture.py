"""``tests/wem_fixture.py`` on the port's ``tools/wwise_vorbis.py``.

The fixture builds Wwise ``.wem`` files from real Vorbis packets with the
bit IO of the converter it tests. This module compiles the fixture's own
source with its one import pointed at the port's copy of the converter, so
``chip_smoke.py`` builds the same files without loading the JAX package
(``tests/test_torch_tools_wem.py`` holds the two ``build_wem``s' bytes equal).
"""
from pathlib import Path

_PATH = Path(__file__).with_name("wem_fixture.py")
_SRC = _PATH.read_text(encoding="utf-8")
_JAX_IMPORT = "from xva_trainer_tpu.tools.wwise_vorbis import ("
if _SRC.count(_JAX_IMPORT) != 1:
    raise ImportError(f"{_PATH} no longer imports the converter as {_JAX_IMPORT!r}")
exec(compile(_SRC.replace(_JAX_IMPORT, "from xva_trainer_tpu_torch.tools.wwise_vorbis import ("),
             str(_PATH), "exec"), globals())
