"""The port's online layer against the reference's ``repro.online``.

The streaming estimator, the drift detector, the warm refresher and the
controller are numpy on both sides (the port's ``online/streaming.py`` is
a verbatim copy; ``online/refresh.py`` differs only in its imports and in
the device its ``ScheduleArrays`` land on), so the same seeded Pi and
label streams must give the same Pi_hat, the same triggers, the same W,
coefficients and permutations, and the same event and ``refresh_log``
records. Sizes follow ``tests/test_online.py`` or are smaller.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.mixing as J_mix  # noqa: E402
import repro.online as J_on  # noqa: E402
from repro.core.stl_fw import learn_topology as j_learn  # noqa: E402
from repro.data.drift import AbruptLabelSwap as J_AbruptLabelSwap  # noqa: E402
from repro.data.drift import labels_stream as j_labels_stream  # noqa: E402

import repro_torch.online as T_on  # noqa: E402
from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.drift import AbruptLabelSwap, labels_stream  # noqa: E402
from repro_torch.online.refresh import RefreshError, RefreshTimeoutError  # noqa: E402

TIMING_KEYS = {"solve_s", "overlap_wall_s", "blocked_s", "refresh_s", "wall_s"}


def _one_hot_pi(n, K):
    return np.eye(K)[np.arange(n) % K].astype(float)


def _small_problem(n=16, K=4, budget=4, seed=0):
    Pi = np.random.default_rng(seed).dirichlet(0.3 * np.ones(K), size=n)
    return Pi, learn_topology(Pi, budget=budget, lam=0.1)


def _untimed(records):
    """Event / refresh_log records without their wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in records]


def _port_ctl(res, Pi0, budget=6, lam=0.5):
    ref = T_on.TopologyRefresher(res, T_on.RefreshConfig(budget=budget, lam=lam), device="cpu")
    return T_on.OnlineTopologyController(ref, Pi0=Pi0)


def _ref_ctl(res, Pi0, budget=6, lam=0.5):
    ref = J_on.TopologyRefresher(res, J_on.RefreshConfig(budget=budget, lam=lam))
    return J_on.OnlineTopologyController(ref, Pi0=Pi0)


# ---------------------------------------------------------------------------
# streaming estimation and drift detection
# ---------------------------------------------------------------------------

def test_streaming_estimator_and_detector_match_reference():
    n, K = 12, 4
    Pi0 = _one_hot_pi(n, K)
    scenario = AbruptLabelSwap(Pi0, t_drift=20, node_perm=np.random.default_rng(3).permutation(n))
    j_scenario = J_AbruptLabelSwap(Pi0, t_drift=20,
                                   node_perm=np.random.default_rng(3).permutation(n))
    labels = labels_stream(scenario, 50, 8, seed=0)
    np.testing.assert_array_equal(labels, j_labels_stream(j_scenario, 50, 8, seed=0))
    est = T_on.StreamingPiEstimator(n, K, beta=0.3, init=Pi0)
    j_est = J_on.StreamingPiEstimator(n, K, beta=0.3, init=Pi0)
    det, j_det = T_on.DriftDetector(), J_on.DriftDetector()
    W = learn_topology(Pi0, budget=4, lam=0.5).W
    from repro_torch.core.heterogeneity import tau_bar_label_skew

    fired = []
    for t in range(50):
        np.testing.assert_array_equal(est.update(labels[t]), j_est.update(labels[t]))
        value = tau_bar_label_skew(W, est.Pi_hat, 1.0, 0.0)
        trig = det.update(value)
        assert trig == j_det.update(value)
        fired.append(trig)
        if trig:
            det.rebase(value)
            j_det.rebase(value)
    assert any(fired) and not any(fired[:20])  # fires on the drift, not before


# ---------------------------------------------------------------------------
# the warm refresher
# ---------------------------------------------------------------------------

def test_refresher_matches_reference_and_hands_out_device_arrays():
    rng = np.random.default_rng(8)
    n, K = 16, 4
    Pi = _one_hot_pi(n, K)
    r0 = learn_topology(Pi, budget=6, lam=0.5, lmo="auction")
    ref = T_on.TopologyRefresher(r0, T_on.RefreshConfig(budget=6, lam=0.5), lmo="auction",
                                 device="cpu")
    j_ref = J_on.TopologyRefresher(j_learn(Pi, budget=6, lam=0.5, lmo="auction"),
                                   J_on.RefreshConfig(budget=6, lam=0.5), lmo="auction")
    assert (ref.l_max, ref.lam, ref.gap_ref) == (j_ref.l_max, j_ref.lam, j_ref.gap_ref)
    for _ in range(3):
        Pi_t = Pi[rng.permutation(n)]
        res, j_res = ref.refresh(Pi_t), j_ref.refresh(Pi_t)
        np.testing.assert_array_equal(res.W, j_res.W)
        np.testing.assert_array_equal(ref.W, j_ref.W)
        assert ref.schedule.coeffs == j_ref.schedule.coeffs
        assert ref.schedule.perms == j_ref.schedule.perms
        assert ref.last_iters == j_ref.last_iters
        sa, j_sa = ref.schedule_arrays(), j_ref.schedule_arrays()
        assert sa.gammas.device.type == "cpu" and sa.perms.dtype == torch.int32
        np.testing.assert_array_equal(sa.gammas.numpy(), np.asarray(j_sa.gammas))
        np.testing.assert_array_equal(sa.perms.numpy(), np.asarray(j_sa.perms))
    assert ref.n_refreshes == 3 and ref.solver.state is not None


def test_refresher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, res = _small_problem()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_on.TopologyRefresher(res, T_on.RefreshConfig(budget=4, lam=0.1))


# ---------------------------------------------------------------------------
# the controller: inline, pool mode
# ---------------------------------------------------------------------------

def test_inline_controller_matches_reference_on_a_drifting_stream():
    rng = np.random.default_rng(9)
    n, K = 24, 6
    Pi = _one_hot_pi(n, K)
    Pi2 = Pi[rng.permutation(n)]
    res = learn_topology(Pi, budget=6, lam=0.5)
    ctl = _port_ctl(res, Pi)
    j_ctl = _ref_ctl(j_learn(Pi, budget=6, lam=0.5), Pi)
    swaps = []
    for t in range(60):
        labels = np.stack([rng.choice(K, size=16, p=Pi2[i]) for i in range(n)])
        ctl.observe(labels)
        j_ctl.observe(labels)
        sa, j_sa = ctl.on_segment(t), j_ctl.on_segment(t)
        assert (sa is None) == (j_sa is None)
        if sa is not None:
            swaps.append(t)
            assert isinstance(sa, T_mix.ScheduleArrays)
            np.testing.assert_array_equal(sa.gammas.numpy(), np.asarray(j_sa.gammas))
            np.testing.assert_array_equal(sa.perms.numpy(), np.asarray(j_sa.perms))
    assert swaps
    assert _untimed(ctl.events) == _untimed(j_ctl.events)
    assert _untimed(ctl.refresh_log) == _untimed(j_ctl.refresh_log)
    np.testing.assert_array_equal(ctl.refresher.W, j_ctl.refresher.W)


@pytest.mark.parametrize("foreign", [False, True])
def test_pool_mode_matches_reference(foreign):
    Pi, res = _small_problem()
    j_res = j_learn(Pi, budget=4, lam=0.1)
    ref = T_on.TopologyRefresher(res, T_on.RefreshConfig(budget=4, lam=0.1), device="cpu")
    j_ref = J_on.TopologyRefresher(j_res, J_on.RefreshConfig(budget=4, lam=0.1))
    if foreign:  # a pool staged from another schedule: a miss, so a restage
        coeffs = (0.5, 0.5)
        perms = (tuple(np.roll(np.arange(16), 5)), tuple(np.roll(np.arange(16), 7)))
        pool = T_mix.PermPool.from_schedule(T_mix.BirkhoffSchedule(coeffs, perms),
                                            capacity=ref.l_max)
        j_pool = J_mix.PermPool.from_schedule(J_mix.BirkhoffSchedule(coeffs, perms),
                                              capacity=j_ref.l_max)
    else:
        pool = T_mix.PermPool.from_schedule(ref.schedule, capacity=ref.l_max)
        j_pool = J_mix.PermPool.from_schedule(j_ref.schedule, capacity=j_ref.l_max)
    assert pool.perms == j_pool.perms
    ctl = T_on.OnlineTopologyController(
        ref, estimator=T_on.StreamingPiEstimator(16, 4, init=Pi), pool=pool)
    j_ctl = J_on.OnlineTopologyController(
        j_ref, estimator=J_on.StreamingPiEstimator(16, 4, init=Pi), pool=j_pool)
    ctl.request_refresh("drill")
    j_ctl.request_refresh("drill")
    swap, j_swap = ctl.on_segment(0), j_ctl.on_segment(0)
    assert isinstance(swap, T_mix.PoolSwap)
    assert swap.restaged == j_swap.restaged == foreign
    np.testing.assert_array_equal(swap.gammas, j_swap.gammas)
    assert swap.dropped_mass == j_swap.dropped_mass
    assert ctl.pool_misses == j_ctl.pool_misses
    assert ctl.pool.perms == j_ctl.pool.perms
    sa = ctl.pool.arrays_for(swap.gammas, device="cpu")
    j_sa = j_ctl.pool.arrays_for(j_swap.gammas)
    np.testing.assert_array_equal(sa.perms.numpy(), np.asarray(j_sa.perms))
    np.testing.assert_array_equal(ctl.pool.to_matrix(swap.gammas),
                                  j_ctl.pool.to_matrix(j_swap.gammas))
    assert _untimed(ctl.events) == _untimed(j_ctl.events)
    assert _untimed(ctl.refresh_log) == _untimed(j_ctl.refresh_log)


# ---------------------------------------------------------------------------
# overlap mode, retries, timeouts and abandon
# ---------------------------------------------------------------------------

def _slow(cls, seconds, seen=None):
    class Slow(cls):
        def refresh(self, Pi_hat):
            if seen is not None:
                seen.append(threading.get_ident())
            time.sleep(seconds)
            return super().refresh(Pi_hat)

    return Slow


def test_overlap_controller_lands_the_reference_schedule_without_blocking(monkeypatch):
    Pi, res = _small_problem()
    made_on = []  # the threads the schedule's tensors were made on
    real = T_mix.schedule_to_arrays

    def recording(*args, **kwargs):
        made_on.append(threading.get_ident())
        return real(*args, **kwargs)

    from repro_torch.online import refresh as T_refresh
    monkeypatch.setattr(T_refresh, "schedule_to_arrays", recording)
    solved_on = []
    ref = _slow(T_on.TopologyRefresher, 0.3, solved_on)(
        res, T_on.RefreshConfig(budget=4, lam=0.1), device="cpu")
    ctl = T_on.OnlineTopologyController(
        ref, estimator=T_on.StreamingPiEstimator(16, 4, init=Pi), overlap=True)
    j_ctl = J_on.OnlineTopologyController(
        J_on.TopologyRefresher(j_learn(Pi, budget=4, lam=0.1),
                               J_on.RefreshConfig(budget=4, lam=0.1)),
        estimator=J_on.StreamingPiEstimator(16, 4, init=Pi))
    try:
        ctl.request_refresh()
        j_ctl.request_refresh()
        t0 = time.perf_counter()
        assert ctl.on_segment(0) is None  # submitted, not solved inline
        assert time.perf_counter() - t0 < 0.25
        j_sa = j_ctl.on_segment(0)
        swap, t = None, 1
        deadline = time.monotonic() + 10.0
        while swap is None and time.monotonic() < deadline:
            time.sleep(0.05)
            swap = ctl.on_segment(t)
            t += 1
        assert swap is not None
        (rec,) = ctl.refresh_log
        assert rec["blocked_s"] == 0.0 and rec["pending_segments"] >= 1
        assert rec["overlap_wall_s"] >= 0.3
        assert set(rec) == set(j_ctl.refresh_log[0])
        np.testing.assert_array_equal(swap.gammas.numpy(), np.asarray(j_sa.gammas))
        np.testing.assert_array_equal(swap.perms.numpy(), np.asarray(j_sa.perms))
        # the solve ran on the worker; the tensors were made on this thread
        assert solved_on and solved_on[0] != threading.get_ident()
        assert made_on and set(made_on) == {threading.get_ident()}
        # flush: nothing in flight, then a second refresh waited for honestly
        assert ctl.flush() is None
        ctl.request_refresh()
        assert ctl.on_segment(t) is None
        assert ctl.flush(99) is not None
        assert ctl.refresh_log[-1]["blocked_s"] > 0.0
        assert ctl.refresh_log[-1]["t_collect"] == 99
    finally:
        ctl.close()


def test_retries_failures_and_flush_errors_match_reference():
    Pi, res = _small_problem()
    j_res = j_learn(Pi, budget=4, lam=0.1)

    def flaky(cls, fail_first):
        calls = {"n": 0}

        class Flaky(cls):
            def refresh(self, Pi_hat):
                calls["n"] += 1
                if calls["n"] <= fail_first:
                    raise RuntimeError(f"transient #{calls['n']}")
                return super().refresh(Pi_hat)

        return Flaky

    logs = []
    for mod, r in ((T_on, res), (J_on, j_res)):
        kw = {"device": "cpu"} if mod is T_on else {}
        cfg = mod.RefreshConfig(budget=4, lam=0.1)
        # two failures, then success within three retries
        ctl = mod.OnlineTopologyController(
            flaky(mod.TopologyRefresher, 2)(r, cfg, **kw),
            estimator=mod.StreamingPiEstimator(16, 4, init=Pi),
            solve_retries=3, retry_backoff_s=0.001)
        ctl.request_refresh()
        assert ctl.on_segment(0) is not None and ctl.failed_refreshes == 0
        # retries exhausted: one failure, the last-good W kept, re-armed
        broken = mod.OnlineTopologyController(
            flaky(mod.TopologyRefresher, 99)(r, cfg, **kw),
            estimator=mod.StreamingPiEstimator(16, 4, init=Pi),
            solve_retries=2, retry_backoff_s=0.001)
        W_before = broken.refresher.W.copy()
        broken.request_refresh()
        assert broken.on_segment(0) is None and broken.failed_refreshes == 1
        np.testing.assert_array_equal(broken.refresher.W, W_before)
        logs.append((_untimed(ctl.refresh_log), _untimed(broken.refresh_log),
                     _untimed(broken.events)))
    assert logs[0] == logs[1]
    assert logs[0][1][0]["attempts"] == 3

    # an overlap worker's failure re-raises at flush with its metadata
    ref = flaky(T_on.TopologyRefresher, 99)(res, T_on.RefreshConfig(budget=4, lam=0.1),
                                            device="cpu")
    ctl = T_on.OnlineTopologyController(
        ref, estimator=T_on.StreamingPiEstimator(16, 4, init=Pi), overlap=True)
    try:
        ctl.request_refresh()
        assert ctl.on_segment(3) is None
        with pytest.raises(RefreshError) as info:
            ctl.flush(9)
        assert info.value.meta["t_submit"] == 3 and "transient" in info.value.meta["error"]
        assert not ctl.refresh_pending and ctl.failed_refreshes == 1
    finally:
        ctl.close()


def test_timeout_and_abandon():
    Pi, res = _small_problem()
    release = threading.Event()

    class Hanging(T_on.TopologyRefresher):
        def refresh(self, Pi_hat):
            release.wait(timeout=30.0)
            return super().refresh(Pi_hat)

    def controller(**kw):
        ref = Hanging(res, T_on.RefreshConfig(budget=4, lam=0.1), device="cpu")
        return T_on.OnlineTopologyController(
            ref, estimator=T_on.StreamingPiEstimator(16, 4, init=Pi), overlap=True, **kw)

    ctl = controller()
    try:
        ctl.request_refresh()
        assert ctl.on_segment(0) is None
        with pytest.raises(RefreshTimeoutError) as info:
            ctl.flush(1, timeout=0.05)
        assert info.value.meta["timeout_s"] == 0.05
        assert ctl.refresh_pending and ctl.failed_refreshes == 0
        release.set()
        assert ctl.flush(2) is not None
    finally:
        release.set()
        ctl.close()
    release.clear()
    ctl = controller(solve_timeout_s=0.05)
    try:
        ctl.request_refresh()
        assert ctl.on_segment(0) is None
        time.sleep(0.1)
        assert ctl.on_segment(1) is None  # abandoned, never blocked
        assert not ctl.refresh_pending and ctl.failed_refreshes == 1
        assert "solve_timeout_s" in ctl.refresh_log[-1]["error"]
    finally:
        release.set()
        ctl.close()
