"""The fault layer (``repro_torch.faults``, ``train/checkpoints.py``)
against the reference's ``repro.faults``.

The plan and the quarantine controller are numpy copies: their traces,
fingerprints and events must equal the reference's exactly. The fault
runner is held to the reference's at ``benchmarks/bench_faults.py``'s
smoke sizes (n = 8, 120 steps, segments of 20) at 1e-6 relative on the
error traces (float32 sums in another order; 1e-5 where a liar drives
the run up and compounds them), with equal byte meters;
a checkpoint resume must give the uninterrupted run bitwise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.faults as JF  # noqa: E402
import repro.core.mixing as J_mix  # noqa: E402
from repro.data.synthetic import mean_estimation_clusters as j_mec  # noqa: E402
from repro.train import checkpoints as J_ckpt  # noqa: E402

import repro_torch.faults as TF  # noqa: E402
from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.drift import NodeChurn  # noqa: E402
from repro_torch.data.synthetic import mean_estimation_clusters  # noqa: E402
from repro_torch.online import RefreshConfig, TopologyRefresher  # noqa: E402
from repro_torch.train import checkpoints as T_ckpt  # noqa: E402

N, K, STEPS, SEG, BATCH, LR = 8, 4, 120, 20, 2, 0.05

_PLANS = {
    "clean": {},
    "sweep": dict(crash_rate=0.05, mean_outage=6.0, straggler_rate=0.3, tau_max=2,
                  edge_drop_rate=0.1),
    "solver": dict(solve_failure_rate=0.2, solve_hang_rate=0.1),
    "corrupt": dict(corrupt_rate=0.05, mean_corruption=4.0),
}


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_plan_traces_and_fingerprint_equal_the_reference(name):
    port = TF.FaultPlan(n_nodes=N, steps=STEPS, seed=3, **_PLANS[name])
    ref = JF.FaultPlan(n_nodes=N, steps=STEPS, seed=3, **_PLANS[name])
    assert port.fingerprint() == ref.fingerprint()
    for field in ("alive", "delays", "corrupt_mult", "corrupt_xor"):
        assert np.array_equal(getattr(port, field), getattr(ref, field), equal_nan=True), field
    for t in (0, 7, STEPS - 1):
        assert np.array_equal(port.dropped_edges(t), ref.dropped_edges(t))
        assert port.transfer_fracs(t, 1, "degrade") == ref.transfer_fracs(t, 1, "degrade")
    assert [port.solve_fault(k) for k in range(20)] == [ref.solve_fault(k) for k in range(20)]


def test_plan_from_node_churn_equals_the_reference():
    from repro.data.drift import NodeChurn as JNodeChurn

    Pi = np.eye(K)[np.arange(N) % K]
    port = TF.FaultPlan.from_node_churn(NodeChurn(Pi0=Pi, events=((30, 3, 25),), seed=0),
                                        steps=STEPS, seed=5, straggler_rate=0.3, tau_max=2)
    ref = JF.FaultPlan.from_node_churn(JNodeChurn(Pi0=Pi, events=((30, 3, 25),), seed=0),
                                       steps=STEPS, seed=5, straggler_rate=0.3, tau_max=2)
    assert port.fingerprint() == ref.fingerprint()


def _tasks():
    task = mean_estimation_clusters(n_nodes=N, K=K, m=5.0, sigma_tilde2=1.0)
    return task, j_mec(n_nodes=N, K=K, m=5.0, sigma_tilde2=1.0)


def _schedules(task, budget=8):
    s0 = T_mix.schedule_from_result(learn_topology(task.Pi, budget=budget, lam=0.1))
    sa = T_mix.schedule_to_arrays(s0, s0.n_atoms + 2, device="cpu")
    return sa, J_mix.ScheduleArrays(jnp.asarray(sa.gammas.numpy()), jnp.asarray(sa.perms.numpy()))


def _zs(task, seed):
    rng = np.random.default_rng(seed)
    return np.stack([task.sample(BATCH, rng) for _ in range(STEPS)]).astype(np.float32)


def _assert_runs_match(port, ref, rtol=1e-6):
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
        np.testing.assert_allclose(port[key], ref[key], rtol=rtol, atol=1e-7)
    for key in ("comm", "swaps", "alive_frac", "stopped_at", "resumed_from"):
        assert port[key] == ref[key], key
    assert port["n_traces"] == ref["n_traces"] == 1


@pytest.mark.parametrize("policy", [None, "wait", "degrade"])
def test_faulty_runner_matches_reference(policy):
    task, jtask = _tasks()
    sa, jsa = _schedules(task)
    zs = _zs(task, 1)
    kw = dict(lr=LR, seed=2, zs=zs, segment_len=SEG)
    plan_kw = _PLANS["sweep"]
    port = TF.run_faulty_mean_estimation(
        task, TF.FaultPlan(n_nodes=N, steps=STEPS, seed=3, **plan_kw), sa, device="cpu",
        staleness=None if policy is None else T_mix.StragglerPolicy(policy, 1), **kw)
    ref = JF.run_faulty_mean_estimation(
        jtask, JF.FaultPlan(n_nodes=N, steps=STEPS, seed=3, **plan_kw), jsa,
        staleness=None if policy is None else J_mix.StragglerPolicy(policy, 1), **kw)
    _assert_runs_match(port, ref)
    assert port["sq_error_nodes"] is None and port["quarantine"] is None


def test_zero_fault_runner_is_the_fresh_driver_bitwise():
    from repro_torch.train.trainer import run_mean_estimation

    task, _ = _tasks()
    sa, _ = _schedules(task)
    zs = _zs(task, 1)
    fresh = run_mean_estimation(task, None, schedule=sa, steps=STEPS, lr=LR, zs=zs,
                                segment_len=SEG, device="cpu")
    plan = TF.FaultPlan(n_nodes=N, steps=STEPS, seed=0)
    for staleness in (None, T_mix.StragglerPolicy("wait", 4), T_mix.StragglerPolicy("degrade", 4)):
        out = TF.run_faulty_mean_estimation(task, plan, sa, lr=LR, seed=2, zs=zs,
                                            segment_len=SEG, staleness=staleness, device="cpu")
        assert np.array_equal(out["mean_sq_error"], fresh["mean_sq_error"])
        assert np.array_equal(out["theta"], fresh["theta"])
        assert out["comm"]["total_bytes"] == fresh["comm"]["total_bytes"]


@pytest.mark.parametrize("mode", ["nan", "sign_flip", "scale:8", "bitflip"])
def test_screened_runner_and_quarantine_match_reference(mode):
    mult, xor = {"nan": (np.nan, 0), "sign_flip": (-1.0, 0), "scale:8": (8.0, 0),
                 "bitflip": (1.0, 1 << 25)}[mode]
    task, jtask = _tasks()
    sa, jsa = _schedules(task)
    zs = _zs(task, 12)
    kw = dict(lr=LR, seed=2, zs=zs, segment_len=SEG)
    plans = []
    for mod in (TF, JF):
        plan = mod.FaultPlan(n_nodes=N, steps=STEPS, seed=0)
        plan.corrupt_mult[5:, 0] = mult
        plan.corrupt_xor[5:, 0] = xor
        plans.append(plan)
    pol = dict(confirm_streak=2, cooldown_steps=2 * STEPS, probation_steps=8)
    q = TF.QuarantineController(N, TF.ScreenPolicy(**pol), lr=LR)
    jq = JF.QuarantineController(N, JF.ScreenPolicy(**pol), lr=LR)
    port = TF.run_faulty_mean_estimation(task, plans[0], sa, quarantine=q, device="cpu", **kw)
    ref = JF.run_faulty_mean_estimation(jtask, plans[1], jsa, quarantine=jq, **kw)
    # a liar the screen lets through (sign_flip, scale:8 here, as in the
    # reference) drives the run up by orders of magnitude in a few steps,
    # which compounds the float32 rounding of the sums: 1e-5 relative
    _assert_runs_match(port, ref, rtol=1e-5)
    assert q.events == jq.events
    if mode == "nan":  # the hard non-finite screen catches a NaN sender at once
        assert [e["node"] for e in q.events if e["event"] == "quarantine"] == [0]
    assert TF.false_quarantines(q.events, plans[0]) == JF.false_quarantines(jq.events, plans[1]) == 0
    np.testing.assert_allclose(port["sq_error_nodes"], ref["sq_error_nodes"], rtol=1e-5, atol=1e-7)
    assert port["quarantine"] == ref["quarantine"]
    # the screen off: the poison is delivered as the reference delivers it
    off = TF.run_faulty_mean_estimation(task, plans[0], sa, device="cpu", **kw)
    joff = JF.run_faulty_mean_estimation(jtask, plans[1], jsa, **kw)
    np.testing.assert_allclose(off["sq_error_nodes"], joff["sq_error_nodes"], rtol=1e-5,
                               atol=1e-7, equal_nan=True)


def test_clean_screened_runner_is_the_unscreened_run_bitwise():
    task, _ = _tasks()
    sa, _ = _schedules(task)
    kw = dict(lr=LR, seed=2, zs=_zs(task, 12), segment_len=SEG, device="cpu")
    plan = TF.FaultPlan(n_nodes=N, steps=STEPS, seed=0)
    base = TF.run_faulty_mean_estimation(task, plan, sa, **kw)
    q = TF.QuarantineController(N, TF.ScreenPolicy(), lr=LR)
    clean = TF.run_faulty_mean_estimation(task, plan, sa, quarantine=q, **kw)
    assert base["sq_error_nodes"] is None and clean["sq_error_nodes"].shape == (STEPS, N)
    assert np.array_equal(clean["mean_sq_error"], base["mean_sq_error"])
    assert q.n_quarantines == 0 and clean["comm"]["quarantined_bytes"] == 0


def test_quarantine_controller_events_equal_the_reference_on_the_same_stats():
    rng = np.random.default_rng(0)
    n, L, k = 6, 3, 10
    perms = np.stack([np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)])
                      for _ in range(k)]).astype(np.int32)
    gammas = np.tile(np.array([0.4, 0.3, 0.3], np.float32), (k, 1))
    sq_own = rng.random((k, n)).astype(np.float32)
    sq_recv = rng.random((k, L, n)).astype(np.float32)
    sq_recv[:, :, :] += 5.0 * (perms == 2)  # node 2 lies loudly
    dot = (0.5 * rng.random((k, L, n))).astype(np.float32)
    finite = np.ones((k, L, n), bool)
    finite[4:, :, :] &= perms[4:] != 4  # node 4 sends NaNs from step 4
    probes = {"consensus_sq": 0.01 * rng.random(k), "gdev_sq": rng.random(k),
              "gbar_sq": rng.random(k)}
    policy = dict(confirm_streak=2, cooldown_steps=3, probation_steps=2)
    port = TF.QuarantineController(n, TF.ScreenPolicy(**policy), lr=0.1, tau_max=1)
    ref = JF.QuarantineController(n, JF.ScreenPolicy(**policy), lr=0.1, tau_max=1)
    for t0 in (0, k, 2 * k):
        a = port.ingest(t0, T_mix.ScreenStats(sq_own, sq_recv, dot, finite), gammas, perms, probes)
        b = ref.ingest(t0, J_mix.ScreenStats(sq_own, sq_recv, dot, finite), gammas, perms, probes)
        assert np.array_equal(a, b)
    assert port.events == ref.events and port.summary() == ref.summary()


def test_checkpoint_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """The crash-recovery drill of bench_faults: a crash and rejoin, one
    warm refresh landing before the kill, killed after 3 segments and
    resumed from the checkpoint."""
    task, _ = _tasks()
    ref0 = learn_topology(task.Pi, budget=8, lam=0.1)
    plan = TF.FaultPlan.from_node_churn(NodeChurn(Pi0=task.Pi, events=((30, 3, 25),), seed=0),
                                        steps=STEPS, seed=5, straggler_rate=0.3, tau_max=2,
                                        edge_drop_rate=0.05)

    def make_hook():
        refresher = TopologyRefresher(ref0, RefreshConfig(budget=4, lam=0.1), device="cpu")
        done = {"swapped": False}

        def hook(t):
            if not done["swapped"] and t >= 39:
                done["swapped"] = True
                refresher.refresh(task.Pi)
                return refresher.schedule_arrays()
            return None

        return refresher.schedule_arrays(), hook

    arrays, hook = make_hook()
    kw = dict(lr=LR, seed=2, zs=_zs(task, 4), segment_len=SEG, device="cpu")
    full = TF.run_faulty_mean_estimation(task, plan, arrays, on_segment=hook, **kw)
    assert full["swaps"] == [39] and full["n_traces"] == 1
    arrays, hook = make_hook()
    head = TF.run_faulty_mean_estimation(task, plan, arrays, on_segment=hook,
                                         checkpoint_dir=str(tmp_path), stop_after_segments=3, **kw)
    assert head["stopped_at"] == 60 and head["swaps"] == [39]
    tail = TF.run_faulty_mean_estimation(task, plan, arrays, checkpoint_dir=str(tmp_path),
                                         resume=True, **kw)
    assert tail["resumed_from"] == 60
    glued = np.concatenate([head["mean_sq_error"], tail["mean_sq_error"]])
    assert np.array_equal(glued, full["mean_sq_error"])
    assert np.array_equal(tail["theta"], full["theta"])


def test_checkpoints_round_trip_with_the_reference_manifest(tmp_path):
    tree = {"theta": torch.arange(6, dtype=torch.float32).reshape(3, 2),
            "head": torch.tensor(2), "perms": np.arange(6, dtype=np.int32).reshape(2, 3),
            "nested": [np.ones(2, np.float32), (np.zeros((1, 2)),)]}
    path = T_ckpt.save_checkpoint(str(tmp_path), 7, tree, metadata={"t": 7})
    back, meta = T_ckpt.restore_checkpoint(str(tmp_path), 7, tree)
    assert meta == {"t": 7} and T_ckpt.latest_step(str(tmp_path)) == 7
    assert np.array_equal(back["theta"], tree["theta"].numpy()) and back["head"] == 2
    assert isinstance(back["nested"][1], tuple) and back["nested"][1][0].shape == (1, 2)
    j_tree = {"theta": np.zeros((3, 2), np.float32), "head": np.int64(2),
              "perms": np.zeros((2, 3), np.int32),
              "nested": [np.ones(2, np.float32), (np.zeros((1, 2)),)]}
    j_path = J_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, j_tree)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    j_manifest = json.load(open(os.path.join(j_path, "manifest.json")))
    for key in ("step", "keys", "shapes", "dtypes"):
        assert manifest[key] == j_manifest[key], key
    with pytest.raises(ValueError, match="shape mismatch"):
        T_ckpt.restore_checkpoint(str(tmp_path), 7, {**tree, "theta": torch.zeros(2)})
    mgr = T_ckpt.CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": np.full(2, step)})
    step, back, _ = mgr.restore_latest({"x": np.zeros(2)})
    assert step == 3 and sorted(os.listdir(mgr.directory)) == ["step_00000002", "step_00000003"]


def test_flaky_refresher_fails_as_the_plan_says():
    plan = TF.FaultPlan(n_nodes=N, steps=4, seed=1, solve_failure_rate=1.0)

    class Inner:
        schedule = "inner"

        def refresh(self, Pi):
            return "solved"

    flaky = TF.FlakyRefresher(Inner(), plan)
    with pytest.raises(RuntimeError, match="injected solve failure"):
        flaky.refresh(None)
    assert flaky.n_injected_failures == 1 and flaky.schedule == "inner"
