"""Shared by ``test_torch_lm_mesh.py`` and ``test_torch_lm_mesh_modes.py``:
the reference's mesh trainer in one subprocess of 4 forced host devices,
the port's arms on 4 gloo ranks (``_torch_ranks.lm_mesh_job``), and the
comparisons.

The reference (``make_train_setup(cfg, mesh, mode=...)`` on the arm's
``(data, model)`` or ``(pod, data, model)`` mesh) takes 3 jitted
``train_step`` calls from its own ``init_params`` on numpy batches of 2
nodes (pods) x 2 sequences x 16 tokens (fsdp: the 4 sequences as one
batch), or 6 steps of ``run_segments`` in segments of 2 with
``rollout="loop"`` and a hook; it writes the losses (and probe series),
the final parameters, EF memory and stale ring (named as the port's
through ``convert``) and its inputs to an ``.npz``. The port runs every
arm on 4 gloo ranks, each from its block of the reference's init
(``convert.lm_shard_from_numpy``) and its slice of each batch
(``TrainSetup.local_batch``), and returns its blocks; a rank's block is
held against the same block of the reference's leaf.

Tolerance (float32): losses and probes within 1e-5 relative; parameters
within 1e-5 relative plus 1e-5 of the leaf's largest magnitude; the bf16
wire element by element, as in ``test_torch_lm_ranks.py``, with the
element's largest magnitude taken over its initial value and the ring's
payloads too (a flip is one rounding of a payload, and the payloads ran
from the initial value through the ring's to the final values).

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

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NODES, B, S, LR = 2, 2, 16, 2e-2
RTOL = 1e-5

_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.core.mixing import (BirkhoffSchedule, PermPool, PoolSwap, StragglerPolicy,
                               schedule_to_arrays)
from repro.models import registry
from repro.obs.probes import HealthProbes
from repro.train.lm_trainer import make_train_setup
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config

out, arms = sys.argv[1], json.loads(sys.argv[2])
NODES, B, S, LR = {NODES}, {B}, {S}, {LR}


class Quarantine:
    def mask(self):
        return np.array([False, True])

    def summary(self):
        return {{"isolated": [1]}}

sched = BirkhoffSchedule(coeffs=(0.7, 0.3), perms=((0, 1), (1, 0)))
arrays = schedule_to_arrays(sched)
W = np.asarray(sched.to_matrix(), np.float32)
W2 = np.asarray([[0.55, 0.45], [0.45, 0.55]], np.float32)
pool0 = PermPool.from_schedule(sched, capacity=3)
g0, _ = pool0.project(sched)
g1 = np.asarray([0.5, 0.5, 0.0], np.float32)
pool1 = PermPool(perms=((1, 0), (0, 1)))
g2 = np.asarray([0.4, 0.6], np.float32)
rng = np.random.default_rng(0)
toks = rng.integers(0, 512, (6, NODES, B, S)).astype(np.int32)
labels = rng.integers(0, 512, (6, NODES, B, S)).astype(np.int32)
delays = np.array([[0, 1], [1, 0], [1, 1]], np.int32)
raw_delays = np.array([[0, 2], [1, 0], [0, 3], [0, 0], [2, 1], [0, 1]], np.int64)
res = {{"coeffs": np.asarray(sched.coeffs, np.float64), "perms": np.asarray(sched.perms, np.int32),
        "W": W, "W2": W2, "tokens": toks, "labels": labels, "delays": delays,
        "raw_delays": raw_delays, "pool0": np.asarray(pool0.perms, np.int32),
        "pool1": np.asarray(pool1.perms, np.int32), "gammas0": np.asarray(g0, np.float32),
        "gammas1": g1, "gammas2": g2}}

def flat(tree, pcfg, stacked):
    return {{k: v.numpy() for k, v in convert.lm_stacked_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), pcfg, node_axis=stacked, device="cpu").items()}}

meshes, inits = {{}}, set()
for arm, kw in arms.items():
    kw = dict(kw)
    name = kw.pop("cfg", "qwen3-0.6b")
    shape = tuple(kw.pop("mesh"))
    mode = kw.pop("mode", "dsgd")
    run = kw.pop("run", None)
    online = kw.pop("online_w", None)
    quarantine = Quarantine() if kw.pop("quarantine", False) else None
    cfg, pcfg = get_smoke_config(name), port_config(name)
    if name not in inits:
        inits.add(name)
        for k, v in flat(registry.init_model(jax.random.PRNGKey(0), cfg), pcfg, False).items():
            res["init/" + name + "/" + k] = v
    if shape not in meshes:
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        meshes[shape] = make_compat_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    mesh = meshes[shape]
    if kw.pop("schedule", False):
        kw["schedule"] = sched
    if online == "pool":
        kw["pool"] = pool0
    if "staleness" in kw:
        kw["staleness"] = StragglerPolicy(*kw["staleness"])
    if kw.pop("probes", False):
        kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
    with set_mesh(mesh):
        setup = make_train_setup(cfg, mesh, mode=mode, lr=LR, online_w=online is not None, **kw)
        params = jax.jit(setup.init_params)(jax.random.PRNGKey(0))
        opt = setup.init_opt_state(params)
        operand = {{"dense": jnp.asarray(W), "arrays": arrays, "pool": jnp.asarray(g0),
                    None: None}}[online]

        def batch_at(t):
            if mode == "fsdp":
                return {{"tokens": jnp.asarray(toks[t].reshape(NODES * B, S)),
                         "labels": jnp.asarray(labels[t].reshape(NODES * B, S))}}
            return {{"tokens": jnp.asarray(toks[t]), "labels": jnp.asarray(labels[t])}}

        if run == "segments":
            def hook(t):
                if online == "pool":
                    return {{1: PoolSwap(gammas=g1), 3: PoolSwap(gammas=g2, pool=pool1)}}.get(t)
                return jnp.asarray(W2) if t == 1 else None
            batches = {{"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}}
            r = setup.run_segments(params, opt, batches, operand if online != "pool" else g0,
                                   segment_len=2, rollout="loop", on_segment=hook,
                                   delays=raw_delays if setup.staleness else None,
                                   quarantine=quarantine)
            res[arm + "/losses"] = np.asarray(r["losses"], np.float64)
            res[arm + "/recompiles"] = np.asarray(r["recompiles"])
            res[arm + "/swaps"] = np.asarray(r["swaps"])
            for key in ("total_bytes", "deferred_bytes", "quarantined_bytes"):
                res[arm + "/" + key] = np.asarray(r["comm"][key], np.float64)
            for pname, series in r.get("health", {{}}).items():
                res[arm + "/health/" + pname] = np.asarray(series, np.float64)
            params = r["params"]
        else:
            step = jax.jit(setup.train_step)
            series = []
            for t in range(3):
                extra = () if operand is None else (operand,)
                if setup.staleness is not None:
                    extra = extra + (jnp.asarray(delays[t]),)
                params, opt, loss = step(params, opt, batch_at(t), *extra)
                series.append(loss if isinstance(loss, dict) else {{"loss": loss}})
            for pname in series[0]:
                res[arm + "/series/" + pname] = np.asarray([float(s[pname]) for s in series])
            if isinstance(opt, dict) and "ef" in opt:
                for k, v in flat(opt["ef"], pcfg, True).items():
                    res[arm + "/ef/" + k] = v
            if isinstance(opt, dict) and "stale" in opt:
                buf = jax.tree_util.tree_map(np.asarray, opt["stale"]["buf"])
                for i in range(NODES):
                    row = convert.lm_node_from_numpy(buf, pcfg, i, lead=1, device="cpu")
                    for k, v in row.items():
                        res.setdefault(arm + "/ring/" + k, np.zeros((NODES,) + tuple(v.shape),
                                                                   np.float32))[i] = v.numpy()
                res[arm + "/head"] = np.asarray(opt["stale"]["head"])
    res[arm + "/comm_bytes"] = np.asarray(-1 if setup.comm_bytes_per_step is None
                                          else setup.comm_bytes_per_step)
    res[arm + "/transport"] = np.asarray(str(setup.sharded_transport))
    for k, v in flat(params, pcfg, mode != "fsdp").items():
        res[arm + "/final/" + k] = v
np.savez(out, **res)
print("REFERENCE_OK")
"""


def run_reference(out: str, arms: dict, timeout: float = 400) -> dict:
    code = textwrap.dedent(_REFERENCE.format(NODES=NODES, B=B, S=S, LR=LR))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code, out, json.dumps(arms)],
                          capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def ref_block(ref: dict, key: str, rank_out: dict, name: str, stacked: bool,
              offset: int = 0) -> np.ndarray:
    """The block of the reference's leaf ``key`` a rank holds (its node's
    row when ``stacked``), by the rank's spec and coordinates."""
    import torch

    from repro_torch.train import sharding

    want = ref[key]
    if stacked:
        want = want[rank_out["node"]]
    return sharding.shard(torch.from_numpy(np.ascontiguousarray(want)),
                          tuple(rank_out["specs"][name]), rank_out["sizes"],
                          rank_out["coords"], offset).numpy()


def assert_blocks(port: list, arm: str, key: str, ref: dict, stacked: bool) -> None:
    for r in port:
        out = r[arm]
        for name, got in out[key].items():
            want = ref_block(ref, f"{arm}/{key}/{name}", out, name, stacked,
                             offset=1 if key == "ring" else 0)
            full = ref[f"{arm}/{key}/{name}"]
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=RTOL * float(np.abs(full).max()),
                                       err_msg=f"{arm}/{key}/{name} rank {r['_rank']}")


def assert_series(port: list, arm: str, ref: dict) -> None:
    for r in port:
        series = r[arm]["series"]
        for name in series[0]:
            np.testing.assert_allclose([s[name] for s in series], ref[f"{arm}/series/{name}"],
                                       rtol=RTOL, err_msg=f"{arm} {name} rank {r['_rank']}")


WIRE_OWN = 2.0 ** -15
WIRE_FLIP = 3 * 2.0 ** -7
WIRE_FLIP_SHARE = 0.02


def wire_mismatch(got: np.ndarray, want: np.ndarray, own: np.ndarray,
                  largest: np.ndarray) -> str | None:
    """``test_torch_lm_ranks._wire_mismatch``: where ``got`` leaves the
    bf16-wire bound against ``want``, else None."""
    d = np.abs(got.astype(np.float64) - want)
    tight = RTOL * np.abs(want) + WIRE_OWN * np.abs(own)
    flips = d > tight
    if flips.mean() > WIRE_FLIP_SHARE:
        return f"{int(flips.sum())} of {d.size} elements over the tight bound"
    over = d > RTOL * np.abs(want) + WIRE_FLIP * largest
    if over.any():
        k = np.flatnonzero(over.reshape(-1))[0]
        return (f"{int(over.sum())} elements over the flip bound, worst {d[over].max():.3e} "
                f"(first: got {got.reshape(-1)[k]:.6e} want {want.reshape(-1)[k]:.6e} "
                f"own {own.reshape(-1)[k]:.6e} largest {largest.reshape(-1)[k]:.6e})")
    return None


def assert_wire_blocks(port: list, arm: str, key: str, ref: dict) -> None:
    """The bf16-wire arm's blocks of ``key`` (final / ef / ring), element
    by element: ``own`` the element's parameter value, ``largest`` the
    largest node magnitude of that element."""
    for r in port:
        out = r[arm]
        off = 1 if key == "ring" else 0
        for name, got in out[key].items():
            want = ref_block(ref, f"{arm}/{key}/{name}", out, name, True, off).astype(np.float64)
            own_key = f"{arm}/{key}/{name}" if key == "ring" else f"{arm}/final/{name}"
            own = ref_block(ref, own_key, out, name, True, off).astype(np.float64)
            full_own = np.abs(ref[own_key]).max(axis=(0, 1) if key == "ring" else 0)
            # a flip is one rounding of a payload: the payloads ran from the
            # element's initial value through the ring's (its last pushes)
            # to its final ones; the largest of them scales it
            cfg_key = next(k for k in ref if k.startswith("init/") and k.endswith("/" + name))
            full_own = np.maximum(full_own, np.abs(ref[cfg_key]))
            if f"{arm}/ring/{name}" in ref:
                full_own = np.maximum(full_own, np.abs(ref[f"{arm}/ring/{name}"]).max(axis=(0, 1)))
            largest = np.broadcast_to(ref_block({"x": full_own}, "x", out, name, False),
                                      want.shape)
            bad = wire_mismatch(got, want, np.broadcast_to(own, want.shape), largest)
            assert bad is None, f"{arm}/{key}/{name} rank {r['_rank']}: {bad}"
