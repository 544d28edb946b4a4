"""The port's LM trainer (``repro_torch.train.lm_trainer``) against the
reference's mesh trainer.

The reference runs in ONE module-scoped subprocess with 8 forced host
devices, on a ``(4, 2)`` ``("data", "model")`` mesh as
``tests/test_distributed.py`` builds it: each arm's ``make_train_setup``
step, jitted, takes 3 steps from the reference's own ``init_params`` on
the same numpy batches, and the subprocess writes the per-step losses,
the final stacked parameters (through ``convert.lm_stacked_from_numpy``,
so named as the port's), the initial ones and the STL-FW schedule to an
``.npz`` under ``tmp_path``. The port then runs each arm with 4 stacked
nodes on the CPU (where the mix sums in the leaf dtype: the reference's)
from those initial parameters.

Arms: a static STL-FW schedule (``learn_topology`` on a 2-domain Pi,
budget 2), the complete graph, momentum 0.9 + ``gossip_every`` 2 +
``grad_accum`` 2, ``online_w`` with the dense W and with its
``ScheduleArrays``, and ``fsdp`` on the 8 rows at once; then the
robustness options as ``tests/test_torch_lm_ranks.py`` runs them over
ranks: EF (bf16) plus bounded delay (wait, tau_max 1) in one carry on the
staged pool, top-k EF (a quarter kept) on the ``ScheduleArrays``, probes
(``consensus``, ``grad_dev``) on it, and ``run_segments`` (6 steps in
segments of 2, an in-pool ``PoolSwap`` after step 1, a restage after step
3) on the pool transport with probes (the health series) and, under the
degrade policy with raw delays and a quarantine (node 1 isolated), on the
all-gather transport fed pool gammas; qwen3-0.6b's smoke config
(float32), per-node batch 2 x 32 tokens.

Tolerance (float32): losses and probes within 1e-5 relative; every
parameter leaf (and EF memory) within 1e-5 relative plus 1e-5 of the
leaf's largest magnitude (entries near zero have no relative scale); the
bf16 wire element by element, as the rank tests hold it
(``_torch_mesh.wire_mismatch``). Port-only: the rollouts (``"scan"`` and
``"loop"``) equal three ``train_step`` calls, also over the EF + stale
carry; a swap in ``run_segments`` adds no capture; a resumed
``run_segments`` is bitwise the uninterrupted one, also over the EF +
stale carry and a restage; probes are bitwise the probes-off run; every
robustness option and ``run_segments`` argument builds and runs on
stacked nodes; ``impl="kernel"`` is refused only where a kernel has no
backward, and ``impl=None`` resolves by device and config.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as J_get_smoke  # noqa: E402
from repro.models import registry as J_registry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.mixing import (BirkhoffSchedule, PermPool, PoolSwap,  # noqa: E402
                                     ScheduleArrays, StragglerPolicy)
from repro_torch.obs import HealthProbes, RetraceGuard, Tracer  # noqa: E402
from repro_torch.train import lm_trainer  # noqa: E402
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_mesh as TM  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAME = "qwen3-0.6b"
N, B, S, STEPS, LR = 4, 2, 32, 3, 2e-2
RTOL = 1e-5
ARMS = {
    "schedule": dict(mode="dsgd", schedule=True),
    "complete": dict(mode="dsgd"),
    "momentum": dict(mode="dsgd", schedule=True, momentum=0.9, gossip_every=2, grad_accum=2),
    "online_dense": dict(mode="dsgd", online_w="dense"),
    "online_arrays": dict(mode="dsgd", online_w="arrays"),
    "fsdp": dict(mode="fsdp"),
    # the robustness options, as tests/test_torch_lm_ranks.py runs them over ranks
    "pool_ef_stale": dict(mode="dsgd", online_w="pool", sharded_transport="pool",
                          compression="bf16", staleness=("wait", 1)),
    "topk_ef": dict(mode="dsgd", online_w="arrays", compression="topk:0.25"),
    "probes": dict(mode="dsgd", online_w="arrays", probes=True),
    "seg_pool": dict(mode="dsgd", online_w="pool", sharded_transport="pool", probes=True,
                     run="segments"),
    "seg_arrays_degrade": dict(mode="dsgd", online_w="pool", sharded_transport="allgather",
                               staleness=("degrade", 1), quarantine=True, run="segments"),
}
# the reference's mesh trainer keeps a top-k that is not its exact per-node
# top-k (XLA forms the payload twice, with different roundings: a kept
# entry's EF memory is then one rounding off zero, and near-ties select
# differently; ROADMAP queue 3): the top-k arm is held to the reference's
# EF transport on generic inputs and to its first step instead
STEP_ARMS = [a for a, kw in ARMS.items() if kw.get("run") is None and a != "topk_ef"]
SEG_ARMS = [a for a, kw in ARMS.items() if kw.get("run") == "segments"]

_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.core import learn_topology, schedule_from_result
from repro.core.mixing import PermPool, PoolSwap, StragglerPolicy, schedule_to_arrays
from repro.obs.probes import HealthProbes
from repro.train.lm_trainer import make_train_setup
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config

out, arms = sys.argv[1], json.loads(sys.argv[2])
N, B, S, STEPS, LR = {N}, {B}, {S}, {STEPS}, {LR}


class Quarantine:
    def mask(self):
        return np.array([False, True, False, False])

    def summary(self):
        return {{"isolated": [1]}}

mesh = make_compat_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = get_smoke_config("{NAME}")
pcfg = port_config("{NAME}")
Pi = np.eye(2)[np.arange(N) % 2].astype(float)
sched = schedule_from_result(learn_topology(Pi, budget=2, lam=0.5))
arrays = schedule_to_arrays(sched)
W = np.asarray(sched.to_matrix(), np.float32)
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (STEPS, N, B, S)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (STEPS, N, B, S)).astype(np.int32)
pool0 = PermPool.from_schedule(sched, capacity=4)
g0, _ = pool0.project(sched)
g1 = np.asarray(g0, np.float32)[::-1].copy()
pool1 = PermPool(perms=tuple(tuple(int(x) for x in rng.permutation(N)) for _ in range(3))
                 + (tuple(range(N)),))
g2 = np.asarray([0.3, 0.2, 0.2, 0.3], np.float32)
toks6 = rng.integers(0, cfg.vocab_size, (6, N, B, S)).astype(np.int32)
labels6 = rng.integers(0, cfg.vocab_size, (6, N, B, S)).astype(np.int32)
delays = np.array([[0, 1, 0, 1], [1, 0, 0, 0], [0, 0, 1, 1]], np.int32)
raw_delays = np.array([[0, 2, 0, 1], [1, 0, 0, 0], [0, 0, 3, 1], [0, 0, 0, 0],
                       [2, 1, 0, 0], [0, 1, 1, 0]], np.int64)
res = {{"coeffs": np.asarray(sched.coeffs, np.float64),
        "perms": np.asarray(sched.perms, np.int32), "tokens": toks, "labels": labels,
        "tokens6": toks6, "labels6": labels6, "delays": delays, "raw_delays": raw_delays,
        "pool0": np.asarray(pool0.perms, np.int32), "pool1": np.asarray(pool1.perms, np.int32),
        "gammas0": np.asarray(g0, np.float32), "gammas1": g1, "gammas2": g2}}

def port_tree(tree, node=True):
    return convert.lm_stacked_from_numpy(jax.tree_util.tree_map(np.asarray, tree), pcfg,
                                         node_axis=node, device="cpu")

with set_mesh(mesh):
    for arm, kw in arms.items():
        kw = dict(kw)
        mode = kw.pop("mode")
        run = kw.pop("run", None)
        online = kw.pop("online_w", None)
        quarantine = Quarantine() if kw.pop("quarantine", False) else None
        schedule = sched if kw.pop("schedule", False) else None
        if online == "pool":
            kw["pool"] = pool0
        if "staleness" in kw:
            kw["staleness"] = StragglerPolicy(*kw["staleness"])
        if kw.pop("probes", False):
            kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
        setup = make_train_setup(cfg, mesh, mode=mode, schedule=schedule, lr=LR,
                                 online_w=online is not None, **kw)
        node = mode != "fsdp"
        params = jax.jit(setup.init_params)(jax.random.PRNGKey(0))
        if arm == "schedule":
            for k, v in port_tree(params).items():
                res["init/" + k] = v.numpy()
        opt = setup.init_opt_state(params)
        operand = {{"dense": jnp.asarray(W), "arrays": arrays, "pool": jnp.asarray(g0),
                    None: None}}[online]
        if run == "segments":
            def hook(t):
                if t == 1:
                    return PoolSwap(gammas=g1)
                if t == 3:
                    return PoolSwap(gammas=g2, pool=pool1)
                return None
            batches = {{"tokens": jnp.asarray(toks6), "labels": jnp.asarray(labels6)}}
            r = setup.run_segments(params, opt, batches, g0, segment_len=2, rollout="loop",
                                   on_segment=hook,
                                   delays=raw_delays if setup.staleness else None,
                                   quarantine=quarantine)
            res[arm + "/losses"] = np.asarray(r["losses"], np.float64)
            res[arm + "/recompiles"] = np.asarray(r["recompiles"])
            res[arm + "/swaps"] = np.asarray(r["swaps"])
            for key in ("total_bytes", "deferred_bytes", "quarantined_bytes"):
                res[arm + "/" + key] = np.asarray(r["comm"][key], np.float64)
            for name, series in r.get("health", {{}}).items():
                res[arm + "/health/" + name] = np.asarray(series, np.float64)
            params = r["params"]
            setup = r["setup"]
        else:
            step = jax.jit(setup.train_step)
            series = []
            for t in range(STEPS):
                if node:
                    batch = {{"tokens": jnp.asarray(toks[t]), "labels": jnp.asarray(labels[t])}}
                else:
                    batch = {{"tokens": jnp.asarray(toks[t].reshape(N * B, S)),
                              "labels": jnp.asarray(labels[t].reshape(N * B, S))}}
                extra = () if operand is None else (operand,)
                if setup.staleness is not None:
                    extra = extra + (jnp.asarray(delays[t]),)
                params, opt, loss = step(params, opt, batch, *extra)
                series.append(loss if isinstance(loss, dict) else {{"loss": loss}})
            for name in series[0]:
                res[arm + "/series/" + name] = np.asarray([float(x[name]) for x in series])
            res[arm + "/losses"] = res[arm + "/series/loss"]
            if isinstance(opt, dict) and "ef" in opt:
                for k, v in port_tree(opt["ef"]).items():
                    res[arm + "/ef/" + k] = v.numpy()
            if isinstance(opt, dict) and "stale" in opt:
                buf = jax.tree_util.tree_map(np.asarray, opt["stale"]["buf"])
                for i in range(N):
                    row = convert.lm_node_from_numpy(buf, pcfg, i, lead=1, device="cpu")
                    for k, v in row.items():
                        res.setdefault(arm + "/ring/" + k, np.zeros((N,) + tuple(v.shape),
                                                                   np.float32))[i] = v.numpy()
                res[arm + "/head"] = np.asarray(opt["stale"]["head"])
        res[arm + "/comm_bytes"] = np.asarray(-1 if setup.comm_bytes_per_step is None
                                              else setup.comm_bytes_per_step)
        res[arm + "/transport"] = np.asarray(str(setup.sharded_transport))
        for k, v in port_tree(params, node).items():
            res[arm + "/final/" + k] = v.numpy()
# the reference's EF transport with the top-k wire, one node a data
# coordinate, on generic inputs: the exact per-node top-k it documents
from repro.compat import shard_map
from repro.core.compression import make_compressor, mix_arrays_sharded_ef
trng = np.random.default_rng(5)
tx = {{"a": trng.normal(size=(N, 64, 96)).astype(np.float32),
       "b": trng.normal(size=(N, 33)).astype(np.float32)}}
te = {{k: (0.1 * trng.normal(size=v.shape)).astype(np.float32) for k, v in tx.items()}}
topk = make_compressor("topk:0.25")
with set_mesh(mesh):
    f = shard_map(lambda x, e: jax.tree_util.tree_map(lambda v: v[None], mix_arrays_sharded_ef(
        jax.tree_util.tree_map(lambda v: v[0], x), jax.tree_util.tree_map(lambda v: v[0], e),
        arrays, "data", topk)), mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), axis_names={{"data"}}, check_vma=False)
    tm, tn = jax.jit(f)(tx, te)
for k in tx:
    res["topk_transport/x/" + k], res["topk_transport/e/" + k] = tx[k], te[k]
    res["topk_transport/mixed/" + k] = np.asarray(tm[k])
    res["topk_transport/ef/" + k] = np.asarray(tn[k])
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    out = str(tmp_path_factory.mktemp("lm_trainer") / "reference.npz")
    code = textwrap.dedent(_REFERENCE.format(N=N, B=B, S=S, STEPS=STEPS, LR=LR, NAME=NAME))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code, out, json.dumps(ARMS)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _schedule(ref) -> BirkhoffSchedule:
    return BirkhoffSchedule(coeffs=tuple(float(c) for c in ref["coeffs"]),
                            perms=tuple(tuple(int(i) for i in p) for p in ref["perms"]))


def _init(ref, node: bool = True) -> dict:
    out = {k[len("init/"):]: torch.as_tensor(v) for k, v in ref.items() if k.startswith("init/")}
    return out if node else {k: v[0].clone() for k, v in out.items()}


def _batches(ref, node: bool = True) -> dict:
    toks, labels = ref["tokens"].astype(np.int64), ref["labels"].astype(np.int64)
    if not node:
        toks, labels = toks.reshape(STEPS, N * B, S), labels.reshape(STEPS, N * B, S)
    return {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}


def _operand(ref, kind):
    sched = _schedule(ref)
    if kind == "dense":
        return torch.as_tensor(sched.to_matrix(), dtype=torch.float32)
    if kind == "arrays":
        return ScheduleArrays(gammas=torch.as_tensor(sched.coeffs, dtype=torch.float32),
                              perms=torch.as_tensor(np.asarray(sched.perms), dtype=torch.int32))
    if kind == "pool":
        return torch.as_tensor(ref["gammas0"])
    return None


def _pool(ref, j: int) -> PermPool:
    return PermPool(perms=tuple(tuple(int(x) for x in p) for p in ref[f"pool{j}"]))


def _port_setup(ref, arm: str, **extra):
    kw = dict(ARMS[arm])
    kw.pop("run", None)
    kw.pop("quarantine", None)
    mode = kw.pop("mode")
    online = kw.pop("online_w", None)
    schedule = _schedule(ref) if kw.pop("schedule", False) else None
    if online == "pool":
        kw["pool"] = _pool(ref, 0)
    if "staleness" in kw:
        kw["staleness"] = StragglerPolicy(*kw["staleness"])
    if kw.pop("probes", False):
        kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
    kw.update(extra)
    setup = make_train_setup(get_smoke_config(NAME), n_nodes=N, mode=mode, schedule=schedule,
                             lr=LR, online_w=online is not None, device="cpu", **kw)
    return setup, _operand(ref, online), mode != "fsdp"


def _step_extra(setup, operand, ref, t: int) -> tuple:
    extra = (operand,) if operand is not None else ()
    if setup.staleness is not None:
        extra = extra + (torch.as_tensor(ref["delays"][t]),)
    return extra


class _Quarantine:
    """A quarantine controller's accounting face: node 1 isolated."""

    def mask(self):
        return np.array([False, True, False, False])

    def summary(self):
        return {"isolated": [1]}


def _segments(ref, setup, operand, **kw):
    """The reference's run_segments drill: 6 steps in segments of 2, an
    in-pool swap after step 1, a restage after step 3."""
    def hook(t):
        if t == 1:
            return PoolSwap(gammas=ref["gammas1"])
        if t == 3:
            return PoolSwap(gammas=ref["gammas2"], pool=_pool(ref, 1))
        return None

    batches = {"tokens": torch.as_tensor(ref["tokens6"].astype(np.int64)),
               "labels": torch.as_tensor(ref["labels6"].astype(np.int64))}
    kw.setdefault("rollout", "loop")
    return setup.run_segments(_init(ref), setup.init_opt_state(_init(ref)), batches, operand,
                              segment_len=2, on_segment=hook,
                              delays=ref["raw_delays"] if setup.staleness else None, **kw)


def _assert_params(port: dict, ref: dict, arm: str, prefix: str = "final/") -> None:
    for name, value in port.items():
        want = ref[f"{arm}/{prefix}{name}"]
        np.testing.assert_allclose(value.numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()), err_msg=name)


def _assert_wire(port: dict, ref: dict, arm: str, key: str) -> None:
    """The bf16-wire arm's final parameters, EF memory or ring element by
    element (``_torch_mesh.wire_mismatch``, as the rank tests hold it):
    ``own`` the element's parameter value (the ring's: its payload),
    ``largest`` the largest node magnitude of the element, over its
    initial value and the ring's payloads too."""
    for name, got in port.items():
        want = ref[f"{arm}/{key}/{name}"].astype(np.float64)
        own = want if key == "ring" else ref[f"{arm}/final/{name}"].astype(np.float64)
        axes = (0, 1) if key == "ring" else (0,)
        largest = np.maximum(np.abs(own).max(axis=axes), np.abs(ref[f"init/{name}"]).max(axis=0))
        if f"{arm}/ring/{name}" in ref:
            largest = np.maximum(largest, np.abs(ref[f"{arm}/ring/{name}"]).max(axis=(0, 1)))
        largest = np.expand_dims(largest, axes)
        bad = TM.wire_mismatch(got.float().numpy(), want, np.broadcast_to(own, want.shape),
                               np.broadcast_to(largest, want.shape))
        assert bad is None, f"{arm}/{key}/{name}: {bad}"


def _three_steps(ref, arm: str, **extra):
    setup, operand, node = _port_setup(ref, arm, **extra)
    params = _init(ref, node)
    opt = setup.init_opt_state(params)
    batches = _batches(ref, node)
    series = []
    for t in range(STEPS):
        params, opt, loss = setup.train_step(params, opt, {k: v[t] for k, v in batches.items()},
                                             *_step_extra(setup, operand, ref, t))
        series.append(loss if isinstance(loss, dict) else {"loss": loss})
    return setup, params, opt, series


@pytest.mark.parametrize("arm", STEP_ARMS)
def test_three_steps_match_reference(reference, arm):
    setup, params, opt, series = _three_steps(reference, arm)
    for name in series[0]:
        got = [s[name] for s in series]
        assert all(v.dtype == torch.float32 and v.shape == () for v in got)
        np.testing.assert_allclose([float(v) for v in got], reference[f"{arm}/series/{name}"],
                                   rtol=RTOL, err_msg=f"{arm} {name}")
    assert set(series[0]) == {k.split("/")[-1] for k in reference
                              if k.startswith(f"{arm}/series/")}
    if ARMS[arm].get("compression") == "bf16":
        _assert_wire(params, reference, arm, "final")
        _assert_wire(opt["ef"], reference, arm, "ef")
        _assert_wire(opt["stale"]["buf"], reference, arm, "ring")
    else:
        _assert_params(params, reference, arm)
        if isinstance(opt, dict) and "ef" in opt:
            _assert_params(opt["ef"], reference, f"{arm}/ef", prefix="")
    if isinstance(opt, dict) and "stale" in opt:
        assert int(opt["stale"]["head"]) == int(reference[f"{arm}/head"])
    # the modeled bytes a node receives a step and the resolved transport
    comm = setup.comm_bytes_per_step
    assert (-1 if comm is None else comm) == int(reference[f"{arm}/comm_bytes"])
    assert str(setup.sharded_transport) == str(reference[f"{arm}/transport"])
    if ARMS[arm].get("gossip_every", 1) > 1:
        assert int(opt["step"]) == STEPS


@pytest.mark.parametrize("arm", SEG_ARMS)
def test_run_segments_swap_restage_and_delays_match_reference(reference, arm):
    """``run_segments`` on stacked nodes: the staged pool with an in-pool
    swap and a restage (probes: the health series), and the degrade
    policy with raw delays and a quarantine on the all-gather transport
    fed pool gammas (their ``ScheduleArrays`` twin)."""
    setup, operand, _ = _port_setup(reference, arm)
    quarantine = _Quarantine() if ARMS[arm].get("quarantine") else None
    out = _segments(reference, setup, operand, quarantine=quarantine)
    np.testing.assert_allclose(out["losses"], reference[f"{arm}/losses"], rtol=RTOL)
    assert out["recompiles"] == int(reference[f"{arm}/recompiles"])
    assert out["swaps"] == reference[f"{arm}/swaps"].tolist() == [1, 3]
    for key in ("total_bytes", "deferred_bytes", "quarantined_bytes"):
        assert out["comm"][key] == pytest.approx(float(reference[f"{arm}/{key}"])), key
    assert set(out.get("health", {})) == {k.split("/")[-1] for k in reference
                                          if k.startswith(f"{arm}/health/")}
    for name, series in out.get("health", {}).items():
        np.testing.assert_allclose(series, reference[f"{arm}/health/{name}"], rtol=RTOL,
                                   err_msg=f"{arm} {name}")
    _assert_params(out["params"], reference, arm)
    live = out["setup"]
    assert live.comm_bytes_per_step == int(reference[f"{arm}/comm_bytes"])
    assert str(live.sharded_transport) == str(reference[f"{arm}/transport"])
    if arm == "seg_pool":
        assert out["recompiles"] == 1 and live.pool.capacity == 4 and live is not setup
    else:
        assert out["quarantine"] == {"isolated": [1]}
        assert out["comm"]["quarantined_bytes"] > 0 and out["comm"]["deferred_bytes"] > 0


def test_topk_ef_matches_the_reference_transport_and_keeps_k(reference):
    """Top-k EF on stacked nodes: the mix of ``core.compression.
    mix_stacked_ef`` on generic inputs is the reference's
    ``mix_arrays_sharded_ef`` (one node a ``data`` coordinate) within 1e-5
    relative, mixed parameters and EF memory; in the trainer the first
    step's loss is the reference's, every node keeps exactly
    ``topk_keep_count`` entries of every leaf a step (its EF memory zero
    there), and the modeled bytes and transport are the reference's."""
    from repro_torch.core.compression import make_compressor, mix_stacked_ef, topk_keep_count

    ref = reference
    x = {k[len("topk_transport/x/"):]: torch.as_tensor(v) for k, v in ref.items()
         if k.startswith("topk_transport/x/")}
    e = {k: torch.as_tensor(ref[f"topk_transport/e/{k}"]).clone() for k in x}
    arrays = _operand(ref, "arrays")
    mixed, new_e = mix_stacked_ef(x, e, arrays, make_compressor("topk:0.25"))
    assert new_e is e
    for key, got in (("mixed", mixed), ("ef", new_e)):
        for k, v in got.items():
            want = ref[f"topk_transport/{key}/{k}"]
            np.testing.assert_allclose(v.numpy(), want, rtol=RTOL,
                                       atol=RTOL * float(np.abs(want).max()), err_msg=k)
    setup, params, opt, series = _three_steps(ref, "topk_ef")
    np.testing.assert_allclose(float(series[0]["loss"]), ref["topk_ef/series/loss"][0], rtol=RTOL)
    assert all(np.isfinite(float(x["loss"])) for x in series)
    for k, v in opt["ef"].items():
        kept = (v.reshape(N, -1) == 0).sum(dim=1)
        assert (kept == topk_keep_count(v[0].numel(), 0.25)).all(), (k, kept)
    assert setup.comm_bytes_per_step == int(ref["topk_ef/comm_bytes"])
    assert str(setup.sharded_transport) == str(ref["topk_ef/transport"])


def test_bf16_wire_comparison_catches_planted_faults(reference):
    """The bf16-wire arm's comparison fails an EF memory of zeros (as if the
    step never kept it) and a ring one push off (its slots rolled)."""
    _, _, opt, _ = _three_steps(reference, "pool_ef_stale")
    with pytest.raises(AssertionError):
        _assert_wire({k: torch.zeros_like(v) for k, v in opt["ef"].items()}, reference,
                     "pool_ef_stale", "ef")
    with pytest.raises(AssertionError):
        _assert_wire({k: torch.roll(v, 1, dims=1) for k, v in opt["stale"]["buf"].items()},
                     reference, "pool_ef_stale", "ring")


def _ef_stale_inputs(ref, steps: int = STEPS) -> tuple:
    return (torch.as_tensor(np.stack([ref["gammas0"]] * steps)),
            torch.as_tensor(ref["delays"][:steps]))


def test_scan_is_bitwise_loop_over_the_ef_stale_carry(reference):
    """The captured rollout (run eagerly on the CPU, captures counted) and
    the loop over the EF + stale carry: the same losses, parameters, EF
    memory, ring and head, bitwise, and bitwise the ``train_step`` loop."""
    setup, _, _ = _port_setup(reference, "pool_ef_stale")
    params = _init(reference)
    opt = setup.init_opt_state(params)
    batches = _batches(reference)
    runs = {}
    for rollout in ("scan", "loop"):
        multi = setup.multi_step_fn(rollout)
        runs[rollout] = multi(params, opt, batches, *_ef_stale_inputs(reference))
        assert multi.n_traces == (0 if rollout == "scan" else 1)  # one body, one run
    _, _, _, series = _three_steps(reference, "pool_ef_stale")
    (ps, os_, ls), (pl, ol, ll) = runs["scan"], runs["loop"]
    assert torch.equal(ls, ll) and torch.equal(ls, torch.stack([x["loss"] for x in series]))
    assert all(torch.equal(ps[k], pl[k]) for k in ps)
    assert all(torch.equal(os_["ef"][k], ol["ef"][k]) for k in ps)
    assert all(torch.equal(os_["stale"]["buf"][k], ol["stale"]["buf"][k]) for k in ps)
    assert torch.equal(os_["stale"]["head"], ol["stale"]["head"])
    ring = next(iter(ol["stale"]["buf"].values()))
    assert ring.shape[:2] == (N, 2)  # node-first: the reference's stacked layout


def test_checkpoint_resume_is_bitwise_over_the_ef_stale_carry(reference, tmp_path):
    """A run stopped after 2 segments and resumed from its checkpoint
    (after the restage: from the live setup) is bitwise the uninterrupted
    run: losses, parameters, EF memory, ring and head."""
    setup, operand, _ = _port_setup(reference, "pool_ef_stale")
    whole = _segments(reference, setup, operand)
    ck = str(tmp_path / "ck")
    first = _segments(reference, setup, operand, checkpoint_dir=ck, stop_after_segments=2)
    assert first["stopped_at"] == 4 and first["recompiles"] == 1
    rest = _segments(reference, first["setup"], torch.as_tensor(reference["gammas2"]),
                     checkpoint_dir=ck, resume=True)
    assert rest["resumed_from"] == 4 and rest["recompiles"] == 0
    assert np.array_equal(np.concatenate([first["losses"], rest["losses"]]), whole["losses"])
    for key in ("ef",):
        assert all(torch.equal(rest["opt_state"][key][k], whole["opt_state"][key][k])
                   for k in whole["params"])
    assert all(torch.equal(rest["params"][k], whole["params"][k]) for k in whole["params"])
    assert all(torch.equal(rest["opt_state"]["stale"]["buf"][k],
                           whole["opt_state"]["stale"]["buf"][k]) for k in whole["params"])
    assert torch.equal(rest["opt_state"]["stale"]["head"], whole["opt_state"]["stale"]["head"])
    assert torch.equal(rest["mix"], whole["mix"])


def test_probes_are_bitwise_the_probes_off_run(reference):
    _, p_on, _, s_on = _three_steps(reference, "probes")
    _, p_off, _, s_off = _three_steps(reference, "probes", probes=None)
    assert [x["loss"] for x in s_on] == [x["loss"] for x in s_off]
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_on)
    assert set(s_on[0]) == {"loss", "consensus", "grad_dev"} and set(s_off[0]) == {"loss"}


@pytest.mark.parametrize("rollout", ["scan", "loop"])
@pytest.mark.parametrize("arm", ["momentum", "online_arrays", "fsdp"])
def test_rollouts_match_reference_and_each_other(reference, arm, rollout):
    """The multi-step rollout over the same three steps: the reference's
    losses and parameters, and on the CPU bitwise the ``train_step`` loop."""
    setup, operand, node = _port_setup(reference, arm)
    params = _init(reference, node)
    opt = setup.init_opt_state(params)
    batches = _batches(reference, node)
    extra = (operand,) if operand is not None else ()
    multi = setup.multi_step_fn(rollout)
    p, o, losses = multi(params, opt, batches, *extra)
    np.testing.assert_allclose(losses.numpy(), reference[f"{arm}/losses"], rtol=RTOL)
    _assert_params(p, reference, arm)
    q, _, step_losses = params, opt, []
    for t in range(STEPS):
        q, _, loss = setup.train_step(q, _, {k: v[t] for k, v in batches.items()}, *extra)
        step_losses.append(loss)
    assert torch.equal(losses, torch.stack(step_losses))
    assert all(torch.equal(p[k], q[k]) for k in p)
    # the inputs are left as they were; a second call continues from its arguments
    assert torch.equal(params["embed.table"], _init(reference, node)["embed.table"])
    p2, _, losses2 = multi(params, opt, batches, *extra)
    assert torch.equal(losses2, losses) and all(torch.equal(p2[k], p[k]) for k in p)
    assert multi.n_traces == 1  # scan: captured at its 2nd run; loop: one body


def _run(setup, params, opt, batches, operand, **kw):
    return setup.run_segments(params, opt, batches, operand, segment_len=2, **kw)


def _long_batches(steps: int = 8) -> dict:
    rng = np.random.default_rng(1)
    cfg = get_smoke_config(NAME)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, N, B, S)))
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}


def test_run_segments_swap_adds_no_capture(reference):
    setup, operand, _ = _port_setup(reference, "online_arrays")
    params = _init(reference)
    batches = _long_batches()
    L = operand.l_max  # a swap of the same shape: cyclic shifts, equal weights
    dense = ScheduleArrays(gammas=torch.full((L,), 1.0 / L), perms=torch.as_tensor(
        [[(i + j) % N for i in range(N)] for j in range(L)], dtype=torch.int32))
    guard = RetraceGuard()
    tracer = Tracer()
    plain = _run(setup, params, None, batches, operand)
    swapped = _run(setup, params, None, batches, operand,
                   on_segment=lambda t: dense if t == 3 else None,
                   retrace_guard=guard, tracer=tracer)
    assert plain["n_traces"] == swapped["n_traces"] == 1  # captured at the 2nd segment
    assert guard.counts["run_segments.multi_step"] == 1
    assert swapped["swaps"] == [3] and plain["swaps"] == []
    assert np.array_equal(plain["losses"][:5], swapped["losses"][:5])
    assert not np.array_equal(plain["losses"][5:], swapped["losses"][5:])
    assert torch.equal(swapped["mix"].gammas, dense.gammas)
    assert len(tracer.spans("segment.rollout")) == 4
    assert swapped["losses"].shape == (8,) and swapped["recompiles"] == 0
    assert swapped["comm"]["steps"] == 8


@pytest.mark.parametrize("checkpoint_every", [1, 2])
def test_run_segments_resume_is_bitwise(reference, tmp_path, checkpoint_every):
    setup, operand, _ = _port_setup(reference, "online_dense", momentum=0.9, gossip_every=2)
    params = _init(reference)
    opt = setup.init_opt_state(params)
    batches = _long_batches()
    swap = torch.full((N, N), 1.0 / N)

    def hook(t):
        return swap if t == 1 else None

    whole = _run(setup, params, opt, batches, operand, on_segment=hook)
    ck = str(tmp_path / "ck")
    first = _run(setup, params, opt, batches, operand, on_segment=hook, checkpoint_dir=ck,
                 checkpoint_every=checkpoint_every, stop_after_segments=3)
    assert first["stopped_at"] == 6
    rest = _run(setup, params, opt, batches, operand, on_segment=hook, checkpoint_dir=ck,
                checkpoint_every=checkpoint_every, resume=True)
    assert rest["resumed_from"] == 6
    assert np.array_equal(np.concatenate([first["losses"], rest["losses"]]), whole["losses"])
    assert all(torch.equal(rest["params"][k], whole["params"][k]) for k in whole["params"])
    assert torch.equal(rest["opt_state"]["step"], whole["opt_state"]["step"])
    assert all(torch.equal(rest["opt_state"]["m"][k], whole["opt_state"]["m"][k])
               for k in whole["params"])
    assert torch.equal(rest["mix"], swap)  # the pre-crash swap survived


def test_bfloat16_checkpoint_resume_is_bitwise(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(NAME), dtype="bfloat16")
    setup = make_train_setup(cfg, n_nodes=N, lr=1e-2, online_w=True, device="cpu")
    params = setup.init_params(0)
    batches = _long_batches(4)
    w = torch.full((N, N), 1.0 / N)
    whole = _run(setup, params, None, batches, w)
    ck = str(tmp_path / "ck")
    _run(setup, params, None, batches, w, checkpoint_dir=ck, stop_after_segments=1)
    rest = _run(setup, params, None, batches, w, checkpoint_dir=ck, resume=True)
    assert rest["params"]["embed.table"].dtype == torch.bfloat16
    assert all(torch.equal(rest["params"][k], whole["params"][k]) for k in whole["params"])


@pytest.mark.parametrize("kw", [
    dict(mode="dsgd_pod"), dict(sharded_transport="pool", online_w=True),
    dict(pool=True, online_w=True), dict(compression="bf16", online_w=True),
    dict(staleness=StragglerPolicy("wait", 1), online_w=True),
    dict(probes=HealthProbes(consensus=True, grad_dev=True), online_w=True),
], ids=["dsgd_pod", "sharded_pool", "pool", "compression", "staleness", "probes"])
def test_arguments_left_for_later_items_raise(reference, kw):
    """dsgd_pod runs on a (pod, data, model) mesh
    (tests/test_torch_lm_mesh_modes.py): stacked nodes have no pod axis.
    Every robustness option builds on stacked nodes and takes a step (the
    pool on its own transport, or ``"auto"``'s pick)."""
    cfg = get_smoke_config(NAME)
    if kw.get("mode") == "dsgd_pod":
        with pytest.raises(ValueError, match="'pod' mesh axis"):
            make_train_setup(cfg, n_nodes=N, device="cpu", **kw)
        return
    kw = dict(kw)
    if kw.get("sharded_transport") == "pool" or kw.pop("pool", False):
        kw["pool"] = _pool(reference, 0)
    setup = make_train_setup(cfg, n_nodes=N, lr=LR, device="cpu", **kw)
    params = _init(reference)
    opt = setup.init_opt_state(params)
    mix = _operand(reference, "pool" if setup.sharded_transport == "pool" else "arrays")
    extra = (mix,) if setup.staleness is None else (mix, torch.as_tensor(reference["delays"][0]))
    p, o, loss = setup.train_step(params, opt, {k: v[0] for k, v in _batches(reference).items()},
                                  *extra)
    loss = loss["loss"] if isinstance(loss, dict) else loss
    assert torch.isfinite(loss) and set(p) == set(params)
    if "compression" in kw:
        assert setup.compression.label == "bf16" and set(o["ef"]) == set(params)
    if "staleness" in kw:
        assert int(o["stale"]["head"]) == 1


@pytest.mark.parametrize("what", ["delays", "quarantine", "pool_swap", "pool_gammas"])
def test_run_segments_arguments_left_for_later_items_raise(reference, what):
    """``run_segments`` on stacked nodes takes every argument the rank
    layout takes: raw ``delays`` (a staleness setup), a ``quarantine``
    (its bytes metered), an in-pool ``PoolSwap`` (a value change, no
    capture or recompile) and pool-coordinate gammas on the all-gather
    transport (the pool's ``ScheduleArrays`` twin)."""
    kw, extra = {}, {}
    arm = "online_dense"
    if what == "delays":
        arm, extra = "online_arrays", dict(staleness=StragglerPolicy("wait", 1))
        kw["delays"] = np.asarray([[0, 1, 0, 1]] * 4, np.int64)
    elif what == "quarantine":
        kw["quarantine"] = _Quarantine()
    elif what == "pool_swap":
        arm, extra = "seg_pool", dict(probes=None)
        kw["on_segment"] = lambda t: PoolSwap(gammas=reference["gammas1"]) if t == 1 else None
    else:
        arm, extra = "seg_arrays_degrade", dict(staleness=None)
    setup, operand, _ = _port_setup(reference, arm, **extra)
    mix = torch.as_tensor(reference["gammas0"]) if what in ("pool_swap", "pool_gammas") \
        else operand
    out = _run(setup, _init(reference), setup.init_opt_state(_init(reference)),
               _long_batches(4), mix, **kw)
    assert np.isfinite(out["losses"]).all() and out["losses"].shape == (4,)
    assert out["recompiles"] == 0 and out["n_traces"] == 1
    if what == "delays":
        assert out["comm"]["deferred_bytes"] > 0
    elif what == "quarantine":
        assert out["quarantine"] == {"isolated": [1]} and out["comm"]["quarantined_bytes"] > 0
    elif what == "pool_swap":
        assert out["swaps"] == [1] and torch.equal(out["mix"],
                                                   torch.as_tensor(reference["gammas1"]))
    else:
        assert isinstance(out["mix"], ScheduleArrays) and out["mix"].l_max == 4


@pytest.mark.parametrize("case", ["rglru", "float32_on_card", "default_on_cpu",
                                  "default_on_card"])
def test_impl_kernel_is_refused(case):
    """``impl="kernel"`` is refused only where a kernel has no backward: a
    config with RG-LRU layers, a float32 config on the card; ``impl=None``
    resolves to ``"kernel"`` for a bfloat16 attention config on the card
    and to ``"plain"`` on the CPU (one predicate for both)."""
    on_card = case.endswith("on_card")
    if on_card and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's resolution is checked on the card")
    device = "cuda" if on_card else "cpu"
    if case == "rglru":
        with pytest.raises(ValueError, match="backward"):
            make_train_setup(get_smoke_config("recurrentgemma-2b"), n_nodes=2, impl="kernel",
                             device=device)
        assert make_train_setup(get_smoke_config("recurrentgemma-2b"), n_nodes=2,
                                device=device)._core.loss_module.impl == "plain"
    elif case == "float32_on_card":
        cfg = get_smoke_config(NAME)
        assert cfg.dtype == "float32"
        with pytest.raises(ValueError, match="backward"):
            make_train_setup(cfg, n_nodes=N, impl="kernel", device=device)
        assert make_train_setup(cfg, n_nodes=N, device=device)._core.loss_module.impl == "plain"
    else:
        cfg = dataclasses.replace(get_smoke_config(NAME), dtype="bfloat16")
        setup = make_train_setup(cfg, n_nodes=N, device=device)
        assert setup._core.loss_module.impl == ("kernel" if on_card else "plain")
        # an explicit "kernel" trains on the CPU too (autograd through the plain version)
        kernel = make_train_setup(cfg, n_nodes=N, impl="kernel", device=device)
        assert kernel._core.loss_module.impl == "kernel"


def test_online_and_argument_checks(reference):
    cfg = get_smoke_config(NAME)
    with pytest.raises(ValueError, match="fsdp"):
        make_train_setup(cfg, mode="fsdp", online_w=True, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_setup(cfg, n_nodes=N, online_w=True, schedule=_schedule(reference),
                         device="cpu")
    setup, operand, _ = _port_setup(reference, "schedule")
    params = _init(reference)
    batch = {k: v[0] for k, v in _batches(reference).items()}
    with pytest.raises(TypeError, match="online_w"):
        setup.train_step(params, None, batch, operand if operand is not None else
                         torch.eye(N))
    with pytest.raises(ValueError, match="online_w"):
        setup.run_segments(params, None, _long_batches(4), torch.eye(N), segment_len=2)
    ge = make_train_setup(cfg, n_nodes=N, gossip_every=2, device="cpu")
    with pytest.raises(ValueError, match="step counter"):
        ge.train_step(params, None, batch)


def test_stacked_params_round_trip_the_reference_layout():
    """``lm_stacked_to_numpy`` inverts ``lm_stacked_from_numpy`` on the
    reference's node-stacked pytree (qwen3 and recurrentgemma's groups
    and tail, whisper's flat layer lists), bitwise."""
    for name, n in (("qwen3-0.6b", 4), ("recurrentgemma-2b", 2), ("whisper-small", 2)):
        jcfg, pcfg = J_get_smoke(name), get_smoke_config(name)
        single = J_registry.init_model(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(
            lambda x: np.asarray(jnp.broadcast_to(x[None], (n,) + x.shape)), single)
        stacked = convert.lm_stacked_from_numpy(tree, pcfg, device="cpu")
        assert all(v.shape[0] == n and not v.requires_grad for v in stacked.values())
        back = convert.lm_stacked_to_numpy(stacked, pcfg)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
            [jax.tree_util.keystr(p) for p, _ in flat_b]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))


def test_grad_fn_gives_every_nodes_loss(reference):
    setup, _, _ = _port_setup(reference, "complete")
    params = _init(reference)
    batch = {k: v[0] for k, v in _batches(reference).items()}
    losses, grads = setup.grad_fn(params, batch)
    assert losses.shape == (N,) and set(grads) == set(params)
    assert all(g.shape == params[k].shape for k, g in grads.items())
    # equal replicas on different batches: different losses, one mean
    _, _, loss = setup.train_step(params, None, batch)
    assert torch.allclose(losses.mean(), loss)
    assert lm_trainer.gossip_fn(None, N)(grads)["embed.table"].shape == params["embed.table"].shape


def test_training_forward_recomputes_blocks_bitwise(monkeypatch):
    """With ``remat=True`` the training forward recomputes each layer and
    each loss chunk in the backward pass (the reference's remat): the
    losses and gradients are bitwise those of the default forward, which
    keeps its activations and recomputes nothing."""
    from repro_torch.models import transformer

    cfg = get_smoke_config(NAME)
    setup = make_train_setup(cfg, n_nodes=2, lr=1e-2, device="cpu", remat=True)
    params = setup.init_params(0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2, 1024)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}  # 2 loss chunks
    calls = []
    remat = transformer._remat
    monkeypatch.setattr(transformer, "_remat", lambda fn, *a: calls.append(fn) or remat(fn, *a))
    losses, grads = setup.grad_fn(params, batch)
    assert len(calls) == 2 * (cfg.num_layers + 2)  # each node: every layer, both chunks
    calls.clear()
    kept_losses, kept = make_train_setup(cfg, n_nodes=2, lr=1e-2, device="cpu").grad_fn(
        params, batch)
    assert not calls
    assert torch.equal(losses, kept_losses)
    assert all(torch.equal(grads[k], kept[k]) for k in grads)


@pytest.mark.parametrize("name", ["whisper-small", "xlstm-350m"])
def test_stacked_training_of_whisper_and_the_slstm(name):
    """Stacked nodes train whisper (its decoder's position table is given to
    the step beside the parameters) and the xLSTM (the sLSTM time loop runs
    step by step under autograd): each node's loss and gradient are the
    model's own under autograd."""
    from repro_torch.models import registry

    cfg = get_smoke_config(name)
    setup = make_train_setup(cfg, n_nodes=2, lr=1e-2, device="cpu")
    params = setup.init_params(0)
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 2, 16)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    if cfg.arch_type == "audio":
        batch["frames"] = torch.as_tensor(rng.normal(
            0.0, 0.1, (2, 2, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32))
    losses, grads = setup.grad_fn(params, batch)
    model = registry.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
    loss, _ = registry.loss_fn(model, cfg, {k: v[1] for k, v in batch.items()}, impl="plain")
    loss.backward()
    torch.testing.assert_close(losses[1], loss.detach())
    for k, p in model.named_parameters():
        torch.testing.assert_close(grads[k][1], p.grad, msg=k)
    _, _, mean = setup.train_step(params, None, batch)
    assert torch.isfinite(mean)
