"""Which fp32 step misses on the ragged global batch of
``tests/test_torch_dp_step.py``: the port's one-process v3 step or JAX's.
A float64 witness, on the CPU.

    python3 scripts/probe_v3_dp_f64.py [--steps N]

From the test's seeded tiny models and its global batch of 4 (lengths 64,
56, 40 and 44 frames), N micro-steps (default 2) of the v3 step with SGD at
the test's rate, dropout off, the JAX step's own draws fed to the port, are
taken four ways:

- the port in fp32 and JAX in fp32 (under the test's 2-way data mesh);
- the port in float64 (``tests/torch_dist_common.py::run_v3_f64``);
- JAX in float64, in a process of its own with ``jax_enable_x64``: the
  parameters and the audio in float64, the ``jnp.float32`` casts of the STFT,
  the MAS and the audio's dequantisation widened, and each draw made in
  float32 from the step's key, as the fp32 step makes it, then widened.

Each pair's updates are compared tensor by tensor as
``tests/torch_v3_common.py::assert_updates_match`` compares them: the
ratio of the max-abs distance to the bar (1e-3 of the reference update's max
abs, 1e-6 of the model's largest update, 2 ulp of the parameter). Prints one
JSON object: the losses of each run, and for each model and pair the worst
tensors and the count over the bar.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "tests"), REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def jax_f64(path: str) -> None:
    """The float64 JAX step on the inputs saved at ``path``; its losses and
    updated states are saved back beside them."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from xva_trainer_tpu.ops import mas as jmas
    from xva_trainer_tpu.ops import stft as jstft
    from xva_trainer_tpu.train import xvapitch_trainer as jxt

    for mod in (jmas, jstft, jxt):
        mod.jnp = _Wide(jnp)
    normal, uniform = jax.random.normal, jax.random.uniform
    jax.random.normal = lambda key, shape=(), dtype=None: normal(
        key, shape, jnp.float32).astype(jnp.float64)
    jax.random.uniform = lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0: uniform(
        key, shape, jnp.float32, minval, maxval).astype(jnp.float64)
    import test_torch_dp_step as T

    inp = torch.load(path, weights_only=False)
    wide = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)
    b = dict(inp["b"])
    b["wav"] = b["wav"].astype(np.float64) * (1.0 / 32767.0)
    for k in ("pitch", "energy", "dvec"):
        b[k] = b[k].astype(np.float64)
    meta, new = T.jax_v3_mesh_steps(wide(inp["g_params"]), wide(inp["d_params"]), b,
                                    n_steps=inp["steps"])
    torch.save({"meta": meta, "new": new}, path + ".out")


def ratios(old: dict, new: dict, ref: dict) -> dict:
    """Each tensor's max-abs distance of ``new``'s update from ``ref``'s over
    ``assert_updates_match``'s bar."""
    from torch_v3_common import UNUSED

    refs = {k: ref[k].double() - old[k].double() for k in ref if k in new and k not in UNUSED}
    floor = 1e-6 * max(float(r.abs().max()) for r in refs.values())
    out = {}
    for k, r in refs.items():
        bar = (1e-3 * float(r.abs().max()) + floor
               + 2 * float(np.finfo(np.float32).eps) * float(old[k].abs().max()))
        out[k] = float(((new[k].double() - old[k].double()) - r).abs().max()) / bar
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--jax-f64", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax_f64:
        jax_f64(args.jax_f64)
        return 0
    torch.set_num_threads(1)
    import test_torch_dp_step as T
    from torch_dist_common import run_v3, run_v3_f64
    from torch_v3_common import TCFG, draws_of, jax_forward, seeded_params

    from xva_trainer_tpu_torch.interop.convert import train_state_dicts

    g_params, d_params = seeded_params(0)
    b = T.v3_batch()
    out, _, sdp_noise = jax_forward(g_params, d_params, b)
    draws = draws_of(out, b, sdp_noise)
    g_sd, d_sd = train_state_dicts(g_params, d_params, TCFG)
    case = dict(cfg=dataclasses.asdict(TCFG), g_sd=g_sd, d_sd=d_sd, lr=T.DP_LR, seed=11,
                train_mode=False, batches=[b] * args.steps, draws=[draws] * args.steps)
    port32 = run_v3(case)
    j32_meta, j32 = T.jax_v3_mesh_steps(g_params, d_params, b, n_steps=args.steps)
    port64 = run_v3_f64(case)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({"g_params": g_params, "d_params": d_params, "b": b, "steps": args.steps},
                   path)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-f64", path],
                       check=True)
        j64 = torch.load(path + ".out", weights_only=False)
    runs = {"port32": (port32["g"], port32["d"]), "jax32": j32,
            "port64": (port64["g"], port64["d"]), "jax64": j64["new"]}
    losses = {"port32": port32["metas"][-1], "jax32": j32_meta,
              "port64": port64["metas"][-1], "jax64": j64["meta"]}
    keys = ("loss", "loss_mel", "loss_kl", "loss_duration", "loss_pitch", "loss_gen",
            "loss_feat", "loss_disc")
    report = {"steps": args.steps, "lr": T.DP_LR,
              "losses": {r: {k: float(m[k]) for k in keys} for r, m in losses.items()},
              "pairs": {}}
    pairs = (("port32", "jax32"), ("port32", "port64"), ("jax32", "jax64"),
             ("port32", "jax64"), ("jax32", "port64"), ("port64", "jax64"))
    for i, which in enumerate(("generator", "discriminator")):
        old = (g_sd, d_sd)[i]
        for new, ref in pairs:
            r = ratios(old, runs[new][i], runs[ref][i])
            worst = sorted(r, key=r.get, reverse=True)[:4]
            report["pairs"][f"{which}: {new} vs {ref}"] = {
                "worst": [[k, r[k]] for k in worst], "over_bar": sum(v > 1 for v in r.values()),
                "tensors": len(r)}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
