"""Shared by ``test_torch_lm_mesh_families.py`` and
``test_torch_lm_mesh_families_2x2.py``: tensor parallelism of every family
(``train/tensor_parallel.py``), the reference's mesh trainer in one
subprocess of 4 forced host devices and the port on 4 gloo ranks
(``_torch_ranks.lm_families_job``), and the comparisons.

The reference, for each arm, runs its ``make_train_setup`` on the arm's
``(data, model)`` mesh (the complete graph over ``data``): 2 jitted
``train_step`` calls from its own ``init_params`` on numpy batches (2
sequences x 16 tokens a node; whisper's stub frames N(0, 0.1)); it also
takes the whole model's gradient at init on each node's first batch
(``registry.loss_fn`` unsharded, one compile a config) and writes the
losses, the gradients, the initial and final parameters (named as the
port's through ``convert``) to an ``.npz``. The port runs every arm on 4
gloo ranks, each from its block of the reference's init; a rank's block
is held against the same block of the reference's leaf.

Tolerance (float32): losses within 1e-5 relative; gradients and
parameters within 1e-5 relative plus 1e-5 of the leaf's largest
magnitude. No all-gather reads a parameter's storage (no weight is
gathered).

This module imports numpy and torch only: the reference runs in its
subprocess.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

import _torch_mesh as TM
import _torch_ranks

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S, STEPS, LR = 2, 16, 2, 2e-2
RTOL = 1e-5
ALL_ARMS = {
    "recurrentgemma_2x2": dict(cfg="recurrentgemma-2b", mesh=(2, 2)),
    "recurrentgemma_1x4": dict(cfg="recurrentgemma-2b", mesh=(1, 4)),
    "xlstm_2x2": dict(cfg="xlstm-350m", mesh=(2, 2)),
    "xlstm_1x4": dict(cfg="xlstm-350m", mesh=(1, 4)),
    "whisper_2x2": dict(cfg="whisper-small", mesh=(2, 2)),
    "whisper_1x4": dict(cfg="whisper-small", mesh=(1, 4)),
    "deepseek_2x2": dict(cfg="deepseek-v2-236b", mesh=(2, 2)),
    "deepseek_1x4": dict(cfg="deepseek-v2-236b", mesh=(1, 4)),
    "heads_inside_1x4": dict(cfg="recurrentgemma-2b", mesh=(1, 4), over={"num_heads": 6}),
    "vocab_features_1x4": dict(cfg="whisper-small", mesh=(1, 4),
                               over={"vocab_size": 16411, "d_model": 1024}),
}

_REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.models import registry
from repro.train.lm_trainer import make_train_setup
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config

out, arms = sys.argv[1], json.loads(sys.argv[2])
B, S, STEPS, LR = {B}, {S}, {STEPS}, {LR}
res, meshes, grads = {{}}, {{}}, {{}}

def flat(tree, pcfg, node):
    return {{k: v.numpy() for k, v in convert.lm_stacked_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), pcfg, node_axis=node, device="cpu").items()}}

for arm, kw in arms.items():
    over = kw.get("over", {{}})
    cfg = dataclasses.replace(get_smoke_config(kw["cfg"]), **over)
    pcfg = dataclasses.replace(port_config(kw["cfg"]), **over)
    shape = tuple(kw["mesh"])
    nodes = shape[0]
    if shape not in meshes:
        meshes[shape] = make_compat_mesh(shape, ("data", "model"),
                                         axis_types=(AxisType.Auto,) * 2)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (STEPS, nodes, B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (STEPS, nodes, B, S)).astype(np.int32)
    res[arm + "/tokens"], res[arm + "/labels"] = toks, labels
    frames = None
    if cfg.arch_type == "audio":
        frames = rng.normal(0.0, 0.1, (STEPS, nodes, B, cfg.encoder.num_frames,
                                       cfg.d_model)).astype(np.float32)
        res[arm + "/frames"] = frames

    def batch_at(t, node=None):
        b = {{"tokens": toks[t], "labels": labels[t]}}
        if frames is not None:
            b["frames"] = frames[t]
        if node is not None:
            b = {{k: v[node] for k, v in b.items()}}
        return {{k: jnp.asarray(v) for k, v in b.items()}}

    with set_mesh(meshes[shape]):
        setup = make_train_setup(cfg, meshes[shape], mode="dsgd", lr=LR)
        params = jax.jit(setup.init_params)(jax.random.PRNGKey(0))
        opt = setup.init_opt_state(params)
        single = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], params)
        for k, v in flat(single, pcfg, False).items():
            res[arm + "/init/" + k] = v
        step = jax.jit(setup.train_step)
        losses = []
        for t in range(STEPS):
            params, opt, loss = step(params, opt, batch_at(t))
            losses.append(float(loss))
        res[arm + "/losses"] = np.asarray(losses, np.float64)
        for k, v in flat(params, pcfg, True).items():
            res[arm + "/final/" + k] = v
    # the whole model's gradient at init, on each node's first batch (one
    # compile a config: the two meshes' arms share it)
    key = json.dumps([kw["cfg"], over], sort_keys=True)
    if key not in grads:
        grads[key] = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: registry.loss_fn(p, cfg, b)[0]))
    grad = grads[key]
    gl, gs = [], []
    for i in range(nodes):
        l, g = grad(single, batch_at(0, i))
        gl.append(float(l))
        gs.append(jax.tree_util.tree_map(np.asarray, g))
    res[arm + "/grad_losses"] = np.asarray(gl, np.float64)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    for k, v in flat(stacked, pcfg, True).items():
        res[arm + "/grads/" + k] = v
np.savez(out, **res)
print("REFERENCE_OK")
"""




def run_reference(out: str, arms: dict, timeout: float = 400) -> dict:
    code = textwrap.dedent(_REFERENCE.format(B=B, S=S, STEPS=STEPS, LR=LR))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code, out, json.dumps(arms)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def run_port(ref_path: str, arms: dict, tmp, faults: dict | None = None) -> list:
    return _torch_ranks.spawn_ranks(4, _torch_ranks.lm_families_job, tmp, ref_path, arms, LR,
                                    STEPS, faults or {})


def mismatch(rows: list, arm: str, key: str, ref: dict, got_key: str | None = None) -> list:
    """The leaves whose blocks leave the tolerance on some rank."""
    bad = []
    for r in rows:
        out = r[arm]
        for name, got in (out[got_key] if got_key else out[key]).items():
            want = TM.ref_block(ref, f"{arm}/{key}/{name}", out, name, stacked=True)
            full = ref[f"{arm}/{key}/{name}"]
            if not np.allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(full).max())):
                bad.append((name, r["_rank"]))
    return bad


def check_arm(ref: dict, port: list, arm: str) -> None:
    """An arm's losses, node loss and gradient at init, final parameters
    (the rule's block of every leaf) against the reference, and no
    parameter gathered."""
    for r in port:
        out = r[arm]
        np.testing.assert_allclose(out["losses"], ref[f"{arm}/losses"], rtol=RTOL,
                                   err_msg=f"{arm} rank {r['_rank']}")
        np.testing.assert_allclose(out["grad_loss"], ref[f"{arm}/grad_losses"][out["node"]],
                                   rtol=RTOL, err_msg=f"{arm} rank {r['_rank']}")
        # parameters at rest: the rule's block of every leaf
        for name, got in out["final"].items():
            full_shape = ref[f"{arm}/init/{name}"].shape
            spec = tuple(out["specs"][name])
            want = tuple(s // (out["sizes"]["model"] if e == "model" else 1)
                         for s, e in zip(full_shape, spec + (None,) * len(full_shape)))
            assert got.shape == want, (name, got.shape, want)
    assert mismatch(port, arm, "grads", ref) == []
    assert mismatch(port, arm, "final", ref) == []
    # no weight is gathered: every all-gather reads an activation
    assert all(r[arm]["gathered_params"] == 0 for r in port)


