"""The port's typed-config overlays, telemetry and profiler endpoints.

``utils/config.py`` against ``xva_trainer_tpu/utils/config.py`` on the cases
of ``tests/test_config.py`` (the port's ``XvaTrainConfig`` has no
``fused_gd``, so it reports that key as unknown); the ``/resourceUsage``
snapshot, which must not create a CUDA context; ``/profileStart`` and
``/profileStop`` as ``tests/test_telemetry.py`` drives JAX's."""
import asyncio
import dataclasses
import json
import logging
import os

import pytest
import torch

from xva_trainer_tpu.train.xvapitch_trainer import XvaTrainConfig as JaxCfg
from xva_trainer_tpu.utils import config as jax_config
from xva_trainer_tpu_torch.app.server import AppServer
from xva_trainer_tpu_torch.train import profiler
from xva_trainer_tpu_torch.train.xvapitch_trainer import XvaTrainConfig as TorchCfg
from xva_trainer_tpu_torch.utils import config as torch_config
from xva_trainer_tpu_torch.utils import telemetry


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("fused_gd", None)
    return d


CASES = {
    "precedence": dict(json_layer={"batch_size": 8, "gen_lr": 1e-4},
                       message={"batch_size": 12, "bogus_key": 1},
                       cli=["batch_size=24", "save_step=10"], output_dir="/tmp/x"),
    "coercion": dict(json_layer=None, message={"hifi_only": "true", "target_bs": "200",
                                               "use_amp": "off", "gen_lr": "3e-4"},
                     cli=[], output_dir="out"),
    "fused_gd": dict(json_layer=None, message={"fused_gd": False, "patience": "5"},
                     cli=["optimizer=lion"], output_dir="o"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_config_parity(tmp_path, case):
    c = CASES[case]
    path = None
    if c["json_layer"] is not None:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(c["json_layer"]))
    out = {}
    for key, mod, cls in (("jax", jax_config, JaxCfg), ("torch", torch_config, TorchCfg)):
        out[key] = mod.build_config(cls, json_path=str(path) if path else None,
                                    message=c["message"], cli=c["cli"],
                                    output_dir=c["output_dir"])
    (jcfg, junknown), (tcfg, tunknown) = out["jax"], out["torch"]
    assert _fields(tcfg) == _fields(jcfg)
    assert {k: type(v) for k, v in _fields(tcfg).items()} == \
        {k: type(v) for k, v in _fields(jcfg).items()}
    assert [k for k in tunknown if k != "fused_gd"] == junknown
    assert ("fused_gd" in tunknown) == ("fused_gd" in c["message"])
    if case == "precedence":
        assert tcfg.batch_size == 24 and tcfg.gen_lr == 1e-4 and tcfg.save_step == 10
        assert "bogus_key" in tunknown


def test_overlay_coercion_parity():
    layer = {"hifi_only": "true", "target_bs": "200", "seed": 3.0}
    a, ua = jax_config.overlay(JaxCfg(), layer)
    b, ub = torch_config.overlay(TorchCfg(), layer)
    assert _fields(a) == _fields(b) and ua == ub == []
    assert b.hifi_only is True and b.target_bs == 200
    with pytest.raises(TypeError):
        torch_config.overlay({"not": "a dataclass"})
    assert torch_config.cli_layer(["a=1", "junk", " b = x=y "]) == \
        jax_config.cli_layer(["a=1", "junk", " b = x=y "])


def test_snapshot_shape_and_no_cuda_context():
    s = telemetry.snapshot()
    assert {"time", "cpu_percent", "ram", "disk", "device", "pid_rss_gb"} <= set(s)
    assert s["pid_rss_gb"] > 0 and s["ram"]["total_gb"] > 0
    assert s["device"] == {"platform": "uninitialized", "used_gb": 0.0, "total_gb": 0.0,
                           "percent": 0.0}
    # a poll never creates the context
    assert not torch.cuda.is_initialized()
    assert 0.0 <= telemetry.cpu_percent() <= 100.0


def _server():
    lg = logging.getLogger("test_torch_config_telemetry")
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return AppServer(logger=lg)


def test_profile_endpoints(tmp_path):
    """start, a refused second start, stop, a refused second stop, and a
    trace on disk; on the CPU device the activities are the CPU's."""
    async def go():
        srv = _server()
        await srv.handle_http("/setDevice", {"device": "cpu"})
        d = str(tmp_path / "traces")
        r = await srv.handle_http("/profileStart", {"dir": d})
        assert r == {"ok": True, "dir": d}
        r2 = await srv.handle_http("/profileStart", {"dir": d})
        assert not r2["ok"] and r2["dir"] == d
        # the server's work runs on worker threads, and lands in the trace
        await asyncio.to_thread(lambda: (torch.ones((64, 64)) @ torch.ones((64, 64))).sum())
        r3 = await srv.handle_http("/profileStop", {})
        assert r3 == {"ok": True, "dir": d}
        r4 = await srv.handle_http("/profileStop", {})
        assert not r4["ok"]
        found = [f for _, _, fs in os.walk(d) for f in fs]
        assert found and all(f.endswith(".pt.trace.json") for f in found), found
        with open(os.path.join(d, found[0])) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)

    asyncio.run(go())


def test_cuda_trace_refused_without_a_card(tmp_path):
    r = profiler.trace_start(str(tmp_path / "t"), device="cuda")
    assert not r["ok"] and "CUDA" in r["error"]
    assert profiler.trace_stop() == {"ok": False, "error": "no trace running"}


def test_trace_context_and_step_timer(tmp_path):
    with profiler.trace(str(tmp_path / "ctx"), device="cpu"):
        torch.ones(8).sum()
    assert os.listdir(tmp_path / "ctx")
    t = profiler.StepTimer()
    for frames in (100, 200):
        t.start(frames)
        t.stop(step=frames)
    s = t.summary()
    assert s["steps"] == 2 and s["mean_frames_per_s"] > 0
    assert profiler.StepTimer().summary() == {}
