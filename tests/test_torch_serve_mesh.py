"""The sharded serve setup (``serve.engine.make_serve_setup``) against the
reference's (``repro/serve/engine.py``: ``ServeSetup``,
``_cache_specs_for``, ``make_serve_setup``).

* The specs, no ranks: for all ten full configs on ``DeviceMesh``es of
  the production shapes (16, 16) and (2, 16, 16), rank 0 of the
  ``"fake"`` process group (``launch.dryrun.join_fake``), with and without the
  long-context mode, the port's ``cache_specs`` (a list per layer) equal
  the reference's ``_cache_specs_for`` of the counterpart leaf with the
  group axis's None taken out, and its ``param_specs`` the reference's.
* The step: for the smoke configs of qwen3-0.6b, recurrentgemma-2b,
  deepseek-v2-236b, xlstm-350m, whisper-small and qwen3-moe-30b-a3b on
  ``(2, 2)`` and ``(1, 4)`` (long context on for qwen3-0.6b on (1, 4) and
  deepseek on (2, 2), window 8), the port's sharded prefill and 4
  ``serve_step`` calls on 4 gloo ranks (``_torch_ranks.serve_mesh_job``)
  against the reference's jitted ``prefill`` and ``make_serve_setup(...)
  .serve_step`` with its param and cache shardings, on 4 forced host
  devices in a subprocess, both from the same weights (the port's smoke
  model of seed 0, ``convert.lm_params_to_numpy``) and inputs.

Tolerance (float32): every step's logits within 1e-5 of the reference's
largest magnitude; each rank's cache block within 1e-5 relative plus
1e-5 of the leaf's largest magnitude of the same block of the
reference's final cache; the captured decoder (``MeshDecoder``, eager
on the CPU) equal to the ``serve_step`` loop.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S, STEPS, MAX_LEN = 2, 8, 4, 16
RTOL = 1e-5
ARMS = {
    "qwen3_2x2": dict(cfg="qwen3-0.6b", mesh=(2, 2)),
    "qwen3_1x4_long": dict(cfg="qwen3-0.6b", mesh=(1, 4), long=True,
                           over={"long_context_window": 8}),
    "recurrentgemma_2x2": dict(cfg="recurrentgemma-2b", mesh=(2, 2)),
    "recurrentgemma_1x4": dict(cfg="recurrentgemma-2b", mesh=(1, 4)),
    "deepseek_2x2_long": dict(cfg="deepseek-v2-236b", mesh=(2, 2), long=True,
                              over={"long_context_window": 8}),
    "deepseek_1x4": dict(cfg="deepseek-v2-236b", mesh=(1, 4)),
    "xlstm_2x2": dict(cfg="xlstm-350m", mesh=(2, 2)),
    "xlstm_1x4": dict(cfg="xlstm-350m", mesh=(1, 4)),
    "whisper_2x2": dict(cfg="whisper-small", mesh=(2, 2)),
    "whisper_1x4": dict(cfg="whisper-small", mesh=(1, 4)),
    "moe_2x2": dict(cfg="qwen3-moe-30b-a3b", mesh=(2, 2)),
    "moe_1x4": dict(cfg="qwen3-moe-30b-a3b", mesh=(1, 4)),
}

_REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.serve.engine import make_serve_setup, prefill
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config
from repro_torch.models import registry
sys.path.insert(0, sys.argv[3])
import _torch_ranks

out, arms = sys.argv[1], json.loads(sys.argv[2])
B, S, STEPS, MAX_LEN = {B}, {S}, {STEPS}, {MAX_LEN}
res, meshes = {{}}, {{}}

def shardings(specs, mesh):
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda x: isinstance(x, P))

for arm, kw in arms.items():
    over = kw.get("over", {{}})
    cfg = dataclasses.replace(get_smoke_config(kw["cfg"]), **over)
    pcfg = dataclasses.replace(port_config(kw["cfg"]), **over)
    long = kw.get("long", False)
    shape = tuple(kw["mesh"])
    if shape not in meshes:
        meshes[shape] = make_compat_mesh(shape, ("data", "model"),
                                         axis_types=(AxisType.Auto,) * 2)
    mesh = meshes[shape]
    tree = convert.lm_params_to_numpy(registry.init_model(pcfg, seed=0, device="cpu"))
    inp = _torch_ranks.serve_inputs(kw, B, S, STEPS)
    with set_mesh(mesh):
        setup = make_serve_setup(cfg, mesh, batch=B, seq_len=MAX_LEN, long_context=long)
        pshard = shardings(setup.param_specs, mesh)
        params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree), pshard)
        tok = NamedSharding(mesh, P("data", None))
        frames = inp.get("frames")

        def pre(p, tokens, frames):
            return prefill(p, cfg, tokens, max_len=MAX_LEN, frames=frames, long_context=long)

        logits, cache = jax.jit(pre)(params, jnp.asarray(inp["prompt"], jnp.int32),
                                     None if frames is None else jnp.asarray(frames))
        cshard = shardings(setup.cache_specs, mesh)
        cache = jax.device_put(cache, cshard)  # the prefill's cache at its serve placement
        step = jax.jit(setup.serve_step, in_shardings=(pshard, tok, tok, cshard))
        res[arm + "/logits/0"] = np.asarray(logits, np.float32)
        for t in range(STEPS):
            lo, cache = step(params,
                             jax.device_put(jnp.asarray(inp["steps"][t], jnp.int32), tok),
                             jax.device_put(jnp.full((B, 1), S + t, jnp.int32), tok),
                             jax.device_put(cache, cshard))
            res[arm + f"/logits/{{t + 1}}"] = np.asarray(lo, np.float32)
    port_cache = convert.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cache), pcfg,
                                             device="cpu")
    for path, _, t in _torch_ranks._cache_items(port_cache, None):
        res[arm + "/cache/" + "/".join(map(str, path))] = t.numpy()
np.savez(out, **res)
print("REFERENCE_OK")
"""


def _start_reference(out: str) -> subprocess.Popen:
    code = textwrap.dedent(_REFERENCE.format(B=B, S=S, STEPS=STEPS, MAX_LEN=MAX_LEN))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", code, out, json.dumps(ARMS),
                             os.path.dirname(os.path.abspath(__file__))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4 ranks, run at once."""
    out = str(tmp_path_factory.mktemp("serve_mesh") / "reference.npz")
    proc = _start_reference(out)
    try:
        port = _torch_ranks.spawn_ranks(4, _torch_ranks.serve_mesh_job,
                                        tmp_path_factory.mktemp("serve_mesh_port"), ARMS, B, S,
                                        STEPS, MAX_LEN)
        stdout, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "REFERENCE_OK" in stdout, stderr[-3000:]
    with np.load(out) as f:
        ref = {k: f[k] for k in f.files}
    return ref, port


def _rows(full: np.ndarray, coords: dict, sizes: dict) -> np.ndarray:
    """A rank's rows of a (B, ...) array: its block over data."""
    n = sizes["data"]
    if full.shape[0] % n:
        return full
    w = full.shape[0] // n
    return full[coords["data"] * w:(coords["data"] + 1) * w]


@pytest.mark.parametrize("arm", list(ARMS))
def test_serve_step_and_prefill_match_the_reference(runs, arm):
    ref, port = runs
    for r in port:
        out = r[arm]
        for t, got in enumerate(out["logits"]):
            want = _rows(ref[f"{arm}/logits/{t}"], out["coords"], out["sizes"])
            scale = float(np.abs(want).max())
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                                       err_msg=f"{arm} rank {r['_rank']} step {t}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_cache_blocks_equal_the_reference_block(runs, arm):
    from repro_torch.train import sharding

    ref, port = runs
    for r in port:
        out = r[arm]
        for path, spec, got in out["cache"]:
            full = ref[f"{arm}/cache/" + "/".join(map(str, path))]
            want = sharding.shard(torch.as_tensor(full), spec, out["sizes"],
                                  out["coords"]).numpy()
            assert got.shape == want.shape, (arm, path, spec)
            if got.dtype.kind in "iu":
                np.testing.assert_array_equal(got, want)
            else:
                # a fresh mLSTM / sLSTM stabiliser holds -1e30
                scale = float(np.abs(full[np.abs(full) < 1e29]).max(initial=1.0))
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                                           err_msg=f"{arm} rank {r['_rank']} {path}")


@pytest.mark.parametrize("arm", list(ARMS))
def test_captured_decoder_repeats_the_step_loop(runs, arm):
    """``MeshDecoder`` (eager on the CPU, a capture counted at its second
    step) from a second prefill gives the ``serve_step`` loop's logits."""
    _, port = runs
    for r in port:
        out = r[arm]
        assert out["captures"] == 1
        for got, want in zip(out["decoder_logits"], out["logits"][1:]):
            np.testing.assert_array_equal(got, want)


def test_the_splits_the_arms_reach(runs):
    """The placements the arms are for: kv heads split on (2, 2), head_dim
    on (1, 4) (qwen3's 2 kv heads, recurrentgemma's and whisper's), MLA's
    latents and the recurrent states by their last dimension."""
    _, port = runs
    specs = {arm: {path: spec for path, spec, _ in port[0][arm]["cache"]} for arm in ARMS}
    assert specs["qwen3_2x2"][(0, "k")] == ("data", None, "model", None)
    assert specs["qwen3_1x4_long"][(0, "k")] == ("data", None, None, "model")
    assert specs["recurrentgemma_1x4"][(2, "k")] == ("data", None, None, "model")
    assert specs["recurrentgemma_1x4"][(0, "h")] == ("data", "model")
    assert specs["deepseek_1x4"][(0, "c_kv")] == ("data", None, "model")
    assert specs["xlstm_1x4"][(0, "C")] == ("data", None, None, "model")
    assert specs["xlstm_1x4"][(1, "c")] == ("data", None, "model")
    assert specs["whisper_1x4"][("encoder_out",)] == ("data", None, "model")
    assert specs["whisper_1x4"][("self", 0, "k")] == ("data", None, None, "model")


# ---------------------------------------------------------------------------
# The specs on the production meshes, no ranks
# ---------------------------------------------------------------------------

MESHES = {"2d": "16x16", "3d": "2x16x16"}  # launch.mesh.MESHES's names
SHAPES = {False: (128, 32768), True: (1, 524288)}  # decode_32k, long_500k


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("long", [False, True])
def test_specs_equal_the_reference_on_production_meshes(mesh_kind, long):
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MESHES as LAUNCH_MESHES
    from repro_torch.train import sharding

    shape, names = LAUNCH_MESHES[MESHES[mesh_kind]]
    fake = types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    batch, seq_len = SHAPES[long]
    dryrun.join_fake(math.prod(shape))
    try:
        mesh = sharding.make_mesh(shape, names, device_type="cpu")
        for arch in J_ARCH_IDS:
            _check_specs(arch, mesh, fake, batch, seq_len, long)
    finally:
        torch.distributed.destroy_process_group()


def _check_specs(arch: str, mesh, fake, batch: int, seq_len: int, long: bool) -> None:
    """The port's specs of ``arch`` on ``mesh`` against the reference's on
    ``fake`` (a mesh of the same sizes)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as J_get_config
    from repro.serve import engine as J_engine
    from repro_torch.configs import get_config
    from repro_torch.serve import engine
    from repro_torch.train import sharding

    cfg = get_config(arch)
    ref = J_engine.make_serve_setup(J_get_config(arch), fake, batch=batch, seq_len=seq_len,
                                    long_context=long)
    got = engine.make_serve_setup(cfg, mesh, batch=batch, seq_len=seq_len,
                                  long_context=long, device="cpu")
    # parameters: the reference's spec of the counterpart leaf, less the group axis
    want = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_leaves_with_path(
        ref.param_specs, is_leaf=lambda x: isinstance(x, P))}
    for name, spec in got.param_specs.items():
        path, groups = sharding.reference_path(name, cfg)
        ref_spec = [_entry(e) for e in want[path]]
        if groups > 1 or "['stages']" in path:
            del ref_spec[0]
        assert tuple(ref_spec) == spec, (arch, name)
    # caches: leaf by leaf, the layer's slot in the reference's layout
    ref_specs = {jax.tree_util.keystr(p): (s, leaf) for (p, s), leaf in zip(
        jax.tree_util.tree_leaves_with_path(ref.cache_specs,
                                            is_leaf=lambda x: isinstance(x, P)),
        jax.tree_util.tree_leaves(ref.abstract_cache))}
    seen = set()
    for path, spec, leaf in _torch_ranks._cache_items(got.abstract_cache, got.cache_specs):
        key, stacked = _reference_cache_path(path, cfg)
        ref_spec, ref_leaf = ref_specs[key]
        ref_spec = [_entry(e) for e in ref_spec] + [None] * (ref_leaf.ndim - len(ref_spec))
        ref_shape = tuple(ref_leaf.shape)
        if stacked:
            del ref_spec[0]
            ref_shape = ref_shape[1:]
        assert ref_shape == tuple(leaf.shape), (arch, path)
        assert tuple(ref_spec) == tuple(spec) + (None,) * (len(ref_spec) - len(spec)), \
            (arch, path, spec, ref_spec)
        seen.add(key)
    assert seen == set(ref_specs)
    assert got.n_kv_shardable == ref.n_kv_shardable


def _reference_cache_path(path: tuple, cfg) -> tuple[str, bool]:
    """The reference's keystr of a port cache leaf, and whether it is
    stacked on a group axis."""
    from repro_torch.convert import _layer_slots

    if path[0] in ("encoder_out", "self"):
        return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path), False
    i, leaf = path
    reps, plen = _layer_slots(cfg)
    if i < reps * plen:
        return f"['stages'][{i % plen}]['{leaf}']", True
    return f"['tail'][{i - reps * plen}]['{leaf}']", False
