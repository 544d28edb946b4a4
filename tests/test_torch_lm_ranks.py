"""The port's LM trainer with one node per rank
(``make_train_setup(cfg, group=...)``) against the reference's mesh
trainer.

The reference runs in ONE module-scoped subprocess with 4 forced host
devices, on a ``(4, 1)`` ``("data", "model")`` mesh (``mode="dsgd"``,
one node per index of ``data``): each arm takes 3 jitted ``train_step``
calls from the reference's own ``init_params`` on numpy batches (or, for
the ``run_segments`` arms, 6 steps in segments of 2 with ``rollout="loop"``:
an in-pool ``PoolSwap`` after step 1 and a restage after step 3), and the
subprocess writes the losses (and probe series), the final parameters,
EF memories and stale rings (named as the port's through ``convert``),
and the inputs to an ``.npz``. The port runs every arm on 4 gloo ranks of
the CPU (``tests/_torch_ranks.py``), each rank on its row.

Arms (qwen3-0.6b's smoke config, float32, per-node batch 2 x 16 tokens,
lr 2e-2): a static STL-FW schedule (``mix_ppermute``), the complete graph
(``pmean``), momentum 0.9 + ``gossip_every`` 2 + ``grad_accum`` 2,
``online_w`` on the dense W (all-gather), EF (bf16) plus bounded delay
(wait, tau_max 1) in one carry on the staged pool, probes (``consensus``,
``grad_dev``) on the ``ScheduleArrays`` (all-gather), and
``run_segments`` on the pool transport (with probes: the health series)
and, under the degrade policy with raw delays and a quarantine (node 1
isolated: the meter's quarantined bytes), on the all-gather transport
fed pool gammas (run as their ``ScheduleArrays`` twin; the restage is a
value change there).

Tolerance (float32): losses and probes within 1e-5 relative; parameters
within 1e-5 relative plus 1e-5 of the leaf's largest magnitude. On the
bf16 wire a float32 difference of one ulp can flip the wire's rounding of
an element, so that arm is held element by element (``_wire_mismatch``):
every element within 1e-5 relative plus 2^-15 of its own parameter value
(for the EF memory, a 64th of its own scale: a bf16 residual is at most
2^-9 of the value it was cut from), except at most 2% of a leaf's
elements, each within 3 x 2^-7 of the largest node value of that element
(the wire's rounding of the mixed term and of the carried residual, 3
steps); an EF memory of zeros and a ring one push off fail it
(``test_bf16_wire_comparison_catches_planted_faults``). Port-only: the loop rollout bitwise the ``train_step``
loop over the EF + stale carry; ``rollout="scan"`` refused on gloo; a
checkpoint resume bitwise over that carry (rank 0 writes the stacked
layout); probes bitwise the probes-off run.
"""

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
from repro_torch.train.lm_trainer import make_train_setup  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAME = "qwen3-0.6b"
N, B, S, LR = 4, 2, 16, 2e-2
RTOL = 1e-5
ARMS = {
    "schedule": dict(schedule=True),
    "complete": dict(),
    "momentum": dict(schedule=True, momentum=0.9, gossip_every=2, grad_accum=2),
    "online_dense": dict(online_w="dense"),
    "pool_ef_stale": dict(online_w="pool", sharded_transport="pool", compression="bf16",
                          staleness=("wait", 1)),
    "probes": dict(online_w="arrays", probes=True),
    "seg_pool": dict(online_w="pool", sharded_transport="pool", probes=True, run="segments"),
    "seg_arrays_degrade": dict(online_w="pool", sharded_transport="allgather",
                               staleness=("degrade", 1), quarantine=True, run="segments"),
}

_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_compat_mesh, set_mesh
from repro.configs import get_smoke_config
from repro.core import learn_topology, schedule_from_result
from repro.core.mixing import PermPool, PoolSwap, StragglerPolicy, schedule_to_arrays
from repro.obs.probes import HealthProbes
from repro.train.lm_trainer import make_train_setup
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_config

out, arms = sys.argv[1], json.loads(sys.argv[2])


class Quarantine:
    def mask(self):
        return np.array([False, True, False, False])

    def summary(self):
        return {{"isolated": [1]}}

N, B, S, LR = {N}, {B}, {S}, {LR}
mesh = make_compat_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = get_smoke_config("{NAME}")
pcfg = port_config("{NAME}")
Pi = np.eye(2)[np.arange(N) % 2].astype(float)
sched = schedule_from_result(learn_topology(Pi, budget=2, lam=0.5))
arrays = schedule_to_arrays(sched)
W = np.asarray(sched.to_matrix(), np.float32)
pool0 = PermPool.from_schedule(sched, capacity=4)
g0, _ = pool0.project(sched)
g1 = np.asarray(g0, np.float32)[::-1].copy()
rng = np.random.default_rng(0)
pool1 = PermPool(perms=tuple(tuple(int(x) for x in rng.permutation(N)) for _ in range(3))
                 + (tuple(range(N)),))
g2 = np.asarray([0.3, 0.2, 0.2, 0.3], np.float32)
toks = rng.integers(0, cfg.vocab_size, (6, N, B, S)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (6, N, B, S)).astype(np.int32)
delays = np.array([[0, 1, 0, 1], [1, 0, 0, 0], [0, 0, 1, 1]], np.int32)
raw_delays = np.array([[0, 2, 0, 1], [1, 0, 0, 0], [0, 0, 3, 1], [0, 0, 0, 0],
                       [2, 1, 0, 0], [0, 1, 1, 0]], np.int64)
res = {{"coeffs": np.asarray(sched.coeffs, np.float64), "perms": np.asarray(sched.perms, np.int32),
        "W": W, "tokens": toks, "labels": labels, "delays": delays, "raw_delays": raw_delays,
        "pool0": np.asarray(pool0.perms, np.int32), "pool1": np.asarray(pool1.perms, np.int32),
        "gammas0": np.asarray(g0, np.float32), "gammas1": g1, "gammas2": g2}}

def port_tree(tree, lead=False):
    return convert.lm_stacked_from_numpy(jax.tree_util.tree_map(np.asarray, tree), pcfg,
                                         device="cpu") if not lead else None

with set_mesh(mesh):
    for arm, kw in arms.items():
        kw = dict(kw)
        run = kw.pop("run", None)
        online = kw.pop("online_w", None)
        quarantine = Quarantine() if kw.pop("quarantine", False) else None
        if kw.pop("schedule", False):
            kw["schedule"] = sched
        if online == "pool":
            kw["pool"] = pool0
        if "staleness" in kw:
            kw["staleness"] = StragglerPolicy(*kw["staleness"])
        if kw.pop("probes", False):
            kw["probes"] = HealthProbes(consensus=True, grad_dev=True)
        setup = make_train_setup(cfg, mesh, mode="dsgd", lr=LR, online_w=online is not None, **kw)
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
            batches = {{"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}}
            r = setup.run_segments(params, opt, batches, operand if online != "pool" else g0,
                                   segment_len=2, rollout="loop", on_segment=hook,
                                   delays=raw_delays if setup.staleness else None,
                                   quarantine=quarantine)
            res[arm + "/losses"] = np.asarray(r["losses"], np.float64)
            res[arm + "/recompiles"] = np.asarray(r["recompiles"])
            res[arm + "/swaps"] = np.asarray(r["swaps"])
            res[arm + "/total_bytes"] = np.asarray(r["comm"]["total_bytes"], np.float64)
            res[arm + "/deferred_bytes"] = np.asarray(r["comm"]["deferred_bytes"], np.float64)
            res[arm + "/quarantined_bytes"] = np.asarray(r["comm"]["quarantined_bytes"],
                                                         np.float64)
            for name, series in r.get("health", {{}}).items():
                res[arm + "/health/" + name] = np.asarray(series, np.float64)
            params = r["params"]
        else:
            step = jax.jit(setup.train_step)
            series = []
            for t in range(3):
                batch = {{"tokens": jnp.asarray(toks[t]), "labels": jnp.asarray(labels[t])}}
                extra = () if operand is None else (operand,)
                if setup.staleness is not None:
                    extra = extra + (jnp.asarray(delays[t]),)
                params, opt, loss = step(params, opt, batch, *extra)
                series.append(loss if isinstance(loss, dict) else {{"loss": loss}})
            for name in series[0]:
                res[arm + "/series/" + name] = np.asarray([float(s[name]) for s in series])
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
        for k, v in port_tree(params).items():
            res[arm + "/final/" + k] = v.numpy()
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    out = str(tmp_path_factory.mktemp("lm_ranks") / "reference.npz")
    code = textwrap.dedent(_REFERENCE.format(N=N, B=B, S=S, LR=LR, NAME=NAME))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    import time
    tic = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, out, json.dumps(ARMS)],
                          capture_output=True, text=True, timeout=400, env=env)
    print("REFERENCE_S", time.perf_counter() - tic)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as f:
        return out, {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    path, _ = reference
    tmp = tmp_path_factory.mktemp("lm_ranks_port")
    return _torch_ranks.spawn_ranks(N, _torch_ranks.lm_ranks_job, tmp, path, ARMS, LR,
                                    str(tmp / "ckpt"))


def _assert_tree(rows: list, key: str, ref: dict, prefix: str) -> None:
    for name in rows[0][key]:
        got = np.stack([r[key][name] for r in rows])
        want = ref[f"{prefix}/{name}"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                                   err_msg=f"{prefix}/{name}")


WIRE_OWN = 2.0 ** -15  # of an element's own parameter value: 1/64 of a bf16 residual
WIRE_FLIP = 3 * 2.0 ** -7  # of the element's largest node value: two roundings a step
WIRE_FLIP_SHARE = 0.02  # of a leaf's elements


def _wire_mismatch(got: np.ndarray, want: np.ndarray, own: np.ndarray,
                   largest: np.ndarray) -> str | None:
    """Where ``got`` leaves the bf16-wire arm's bound against ``want``
    (module docstring), else None. ``own``: each element's parameter
    value; ``largest``: the largest node magnitude of that element."""
    d = np.abs(got.astype(np.float64) - want)
    tight = RTOL * np.abs(want) + WIRE_OWN * np.abs(own)
    flips = d > tight
    if flips.mean() > WIRE_FLIP_SHARE:
        return f"{int(flips.sum())} of {d.size} elements over the tight bound"
    over = d > RTOL * np.abs(want) + WIRE_FLIP * largest
    if over.any():
        return f"{int(over.sum())} elements over the flip bound, worst {d[over].max():.3e}"
    return None


def _wire_operands(rows: list, key: str, ref: dict, arm: str) -> dict:
    """``{leaf: (got, want, own, largest)}`` of a bf16-wire arm's final
    parameters, EF memory or ring (the ring's own values are its
    parameters; its leaves carry the slot axis after the node axis)."""
    out = {}
    for name in rows[0][key]:
        got = np.stack([r[key][name] for r in rows])
        want = ref[f"{arm}/{key}/{name}"].astype(np.float64)
        own = want if key == "ring" else ref[f"{arm}/final/{name}"].astype(np.float64)
        axes = (0, 1) if key == "ring" else (0,)
        largest = np.broadcast_to(np.abs(own).max(axis=axes, keepdims=True), want.shape)
        out[name] = (got, want, np.broadcast_to(own, want.shape), largest)
    return out


def _assert_wire_tree(rows: list, key: str, ref: dict, arm: str) -> None:
    for name, ops in _wire_operands(rows, key, ref, arm).items():
        bad = _wire_mismatch(*ops)
        assert bad is None, f"{arm}/{key}/{name}: {bad}"


STEP_ARMS = [a for a, kw in ARMS.items() if kw.get("run") is None]
SEG_ARMS = [a for a, kw in ARMS.items() if kw.get("run") == "segments"]


@pytest.mark.parametrize("arm", STEP_ARMS)
def test_three_steps_match_reference_mesh(reference, port, arm):
    _, ref = reference
    for rank_out in port:
        series = rank_out[arm]["series"]
        for name in series[0]:
            np.testing.assert_allclose([s[name] for s in series], ref[f"{arm}/series/{name}"],
                                       rtol=RTOL, err_msg=f"{arm} {name}")
    rows = [r[arm] for r in port]
    if ARMS[arm].get("compression") == "bf16":
        for key in ("final", "ef", "ring"):
            _assert_wire_tree(rows, key, ref, arm)
    else:
        _assert_tree(rows, "final", ref, f"{arm}/final")
        assert "ef" not in rows[0] and "ring" not in rows[0]
    out = port[0][arm]
    assert (-1 if out["comm_bytes"] is None else out["comm_bytes"]) == \
        int(ref[f"{arm}/comm_bytes"])
    assert str(out["transport"]) == str(ref[f"{arm}/transport"])
    if "ring" in out:
        assert all(r[arm]["head"] == int(ref[f"{arm}/head"]) for r in port)
    if "step" in out:
        assert all(r[arm]["step"] == 3 for r in port)


@pytest.mark.parametrize("arm", SEG_ARMS)
def test_run_segments_swap_restage_and_delays_match_reference(reference, port, arm):
    _, ref = reference
    for rank_out in port:
        out = rank_out[arm]
        np.testing.assert_allclose(out["losses"], ref[f"{arm}/losses"], rtol=RTOL)
        assert out["recompiles"] == int(ref[f"{arm}/recompiles"])
        assert out["swaps"] == ref[f"{arm}/swaps"].tolist() == [1, 3]
        assert out["comm"]["total_bytes"] == pytest.approx(float(ref[f"{arm}/total_bytes"]))
        assert out["comm"]["deferred_bytes"] == pytest.approx(
            float(ref[f"{arm}/deferred_bytes"]))
        assert out["comm"]["quarantined_bytes"] == pytest.approx(
            float(ref[f"{arm}/quarantined_bytes"]))
        for name, series in out["health"].items():
            np.testing.assert_allclose(series, ref[f"{arm}/health/{name}"], rtol=RTOL,
                                       err_msg=f"{arm} {name}")
        assert set(out["health"]) == {k.split("/")[-1] for k in ref
                                      if k.startswith(f"{arm}/health/")}
    _assert_tree([r[arm] for r in port], "final", ref, f"{arm}/final")
    assert port[0]["seg_pool"]["recompiles"] == 1  # the restage on the pool transport
    assert port[0]["seg_arrays_degrade"]["quarantine"] == {"isolated": [1]}
    assert port[0]["seg_arrays_degrade"]["comm"]["quarantined_bytes"] > 0


def test_bf16_wire_comparison_catches_planted_faults(reference, port):
    """The bf16-wire arm's comparison fails an EF memory of zeros (as if
    the step never kept it) and a ring one push off (its slots rolled by
    one), on the same reference."""
    _, ref = reference
    rows = [r["pool_ef_stale"] for r in port]
    ef = _wire_operands(rows, "ef", ref, "pool_ef_stale")
    ring = _wire_operands(rows, "ring", ref, "pool_ef_stale")
    big = [name for name, ops in ef.items() if ops[1].size >= 4096]
    assert big
    for name in big:
        got, want, own, largest = ef[name]
        assert _wire_mismatch(np.zeros_like(got), want, own, largest) is not None, name
        got, want, own, largest = ring[name]
        assert _wire_mismatch(np.roll(got, 1, axis=1), want, own, largest) is not None, name


def test_loop_rollout_is_bitwise_the_step_loop_over_the_ef_stale_carry(port):
    assert all(r["_own"]["loop_bitwise_steps"] for r in port)
    assert all(np.isfinite(r["_own"]["multi_losses"]).all() for r in port)


def test_scan_is_refused_on_gloo(port):
    assert all("gloo" in r["_own"]["scan_refused"] for r in port)


def test_checkpoint_resume_is_bitwise(port):
    for r in port:
        res = r["_own"]["resume"]
        assert res["stopped_at"] == 4 and res["resumed_from"] == 4
        assert res["losses"] and res["params"] and res["ef"] and res["ring"] and res["head"]
        assert res["recompiles"] == (1, 0, 1)  # the restage ran before the stop
    # rank 0 wrote the stacked layout: the node axis first
    cfg = get_smoke_config(NAME)
    assert port[0]["_own"]["ckpt_shape"] == [N, cfg.vocab_size, cfg.d_model]
    # each per-node leaf (parameters, EF memory, ring) gathered to rank 0
    # alone, and written before the next gather
    leaves = len(port[0]["pool_ef_stale"]["final"])
    for rank, r in enumerate(port):
        got = r["_own"]["ckpt_gathers"]
        assert got["calls"] == 2 * 3 * leaves  # 2 checkpoints of 3 per-node trees
        assert got["received"] == (got["calls"] if rank == 0 else 0)
        assert got["written_before_next"]


def test_probes_are_bitwise_the_probes_off_run(port):
    assert all(r["_own"]["probes_bitwise"] for r in port)
    assert all(not r["_jax_loaded"] for r in port)


def test_node_rows_of_the_reference_tree():
    """``lm_node_from_numpy`` gives rank i its row of the reference's
    node-stacked tree (the parameters, and with ``lead=1`` the stale
    ring's ``(n, depth, ...)`` leaves), bitwise."""
    jcfg, pcfg = J_get_smoke(NAME), get_smoke_config(NAME)
    single = J_registry.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(jnp.broadcast_to(x[None], (N,) + x.shape))
                                  * np.arange(1, N + 1).reshape((N,) + (1,) * x.ndim), single)
    stacked = convert.lm_stacked_from_numpy(tree, pcfg, device="cpu")
    ring = jax.tree_util.tree_map(lambda x: np.stack([x, 2 * x], axis=1), tree)
    for i in range(N):
        row = convert.lm_node_from_numpy(tree, pcfg, i, device="cpu")
        assert set(row) == set(stacked)
        assert all(torch.equal(row[k], stacked[k][i]) for k in row)
        rrow = convert.lm_node_from_numpy(ring, pcfg, i, lead=1, device="cpu")
        assert all(torch.equal(rrow[k][0], stacked[k][i]) and
                   torch.equal(rrow[k][1], 2 * stacked[k][i]) for k in rrow)


def test_rank_setup_argument_checks():
    """What needs a group, and what the reference refuses, is refused
    before any collective."""
    cfg = get_smoke_config(NAME)
    from repro_torch.obs import HealthProbes
    from repro_torch.core.mixing import StragglerPolicy

    with pytest.raises(ValueError, match="fsdp over ranks takes mesh="):
        make_train_setup(cfg, mode="fsdp", group=object(), device="cpu")
    with pytest.raises(ValueError, match="tau_bar"):
        make_train_setup(cfg, online_w=True, group=object(), device="cpu",
                         probes=HealthProbes(tau_bar=True))
    with pytest.raises(ValueError, match="gossip_every"):
        make_train_setup(cfg, online_w=True, group=object(), device="cpu", gossip_every=2,
                         staleness=StragglerPolicy("wait", 1))
    with pytest.raises(ValueError, match="online_w"):
        make_train_setup(cfg, group=object(), device="cpu", compression="bf16")
    with pytest.raises(ValueError, match="PermPool"):
        make_train_setup(cfg, online_w=True, group=object(), device="cpu",
                         sharded_transport="pool")
