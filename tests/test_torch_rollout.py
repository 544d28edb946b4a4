"""The captured rollout and the online drivers against the reference.

``rollout="scan"`` runs each segment body that recurs as a CUDA graph on
the card; on the CPU the same bodies run eagerly with the same capture
counting, so these tests hold the counting and the swap semantics, the
online pipeline (label stream -> detector -> warm refresh -> swap)
against ``repro.online`` + ``repro.train.trainer``, and ``"scan"``
bitwise equal to ``"loop"``. Error traces are held to 1e-6 (the
observations are the same numpy stream on both sides); classification
runs on the reference's own draws and is held to the tolerance of
``tests/test_torch_trainer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.mixing as J_mix  # noqa: E402
import repro.online as J_on  # noqa: E402
from repro.core.stl_fw import learn_topology as j_learn  # noqa: E402
from repro.train import trainer as J_tr  # noqa: E402

import repro_torch.online as T_on  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.mixing import schedule_from_result, schedule_to_arrays  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.drift import AbruptLabelSwap, labels_stream  # noqa: E402
from repro_torch.data.partition import cluster_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.obs import RetraceGuard, Tracer  # noqa: E402
from repro_torch.train import rollout as T_roll  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402


def _one_hot_pi(n, K):
    return np.eye(K)[np.arange(n) % K].astype(float)


def _drift_problem(n=12, K=4, steps=120, t_drift=40, batch=8):
    """The reference's online end-to-end setup (tests/test_online.py:508):
    an abrupt label swap, observations that follow it."""
    task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=0.25)
    Pi = _one_hot_pi(n, K)
    perm = np.random.default_rng(11).permutation(n)
    labels = labels_stream(AbruptLabelSwap(Pi, t_drift=t_drift, node_perm=perm), steps, batch,
                           seed=0)
    means = np.asarray(task.cluster_means)
    rngz = np.random.default_rng(1)
    zs = np.stack([means[labels[t]] + 0.5 * rngz.normal(size=labels[t].shape)
                   for t in range(steps)])
    return task, Pi, labels, zs


def _feeding_hook(ctl, labels):
    fed = {"t": 0}

    def hook(t):
        while fed["t"] <= t:
            ctl.observe(labels[fed["t"]])
            fed["t"] += 1
        return ctl.on_segment(t)

    return hook


def _controllers(Pi, budget0=4, budget=8, lam=0.5):
    port = T_on.OnlineTopologyController(
        T_on.TopologyRefresher(learn_topology(Pi, budget=budget0, lam=lam),
                               T_on.RefreshConfig(budget=budget, lam=lam), device="cpu"),
        Pi0=Pi)
    ref = J_on.OnlineTopologyController(
        J_on.TopologyRefresher(j_learn(Pi, budget=budget0, lam=lam),
                               J_on.RefreshConfig(budget=budget, lam=lam)),
        Pi0=Pi)
    return port, ref


@pytest.mark.parametrize("rollout", ["scan", "loop"])
def test_online_mean_estimation_matches_reference(rollout):
    steps, seg = 120, 10
    task, Pi, labels, zs = _drift_problem(steps=steps)
    ctl, j_ctl = _controllers(Pi)
    guard = RetraceGuard()
    tracer = Tracer()
    port = T_tr.run_mean_estimation(
        task, None, steps=steps, schedule=ctl.schedule_arrays(), seed=2, zs=zs,
        on_segment=_feeding_hook(ctl, labels), segment_len=seg, rollout=rollout,
        retrace_guard=guard, tracer=tracer, device="cpu")
    ref = J_tr.run_mean_estimation(
        task, None, steps=steps, schedule=j_ctl.schedule_arrays(), seed=2, zs=zs,
        on_segment=_feeding_hook(j_ctl, labels), segment_len=seg)
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port["theta"], ref["theta"], rtol=1e-6, atol=1e-6)
    assert port["swaps"] == ref["swaps"] and port["swaps"]
    assert all(s >= 40 for s in port["swaps"])  # no refresh before the drift
    assert port["n_traces"] == ref["n_traces"] == 1  # swaps recaptured nothing
    assert guard.counts == {"mean_estimation.roll": 1}
    assert port["comm"] == ref["comm"] and port["compression"] is None
    spans = [s for s in tracer.spans() if s.name == "sim.segment"]
    assert [(s.attrs["t0"], s.attrs["k"]) for s in spans] == [(t, seg) for t in range(0, steps, seg)]
    assert ctl.refresher.n_refreshes == j_ctl.refresher.n_refreshes == len(port["swaps"])


def _reference_draws(X, y, idx, steps, batch_size, seed):
    """The reference's init params and (steps, n, batch) minibatch indices."""
    n, dim, num_classes = len(idx), X.shape[1], int(y.max()) + 1
    params0 = J_tr.init_linear_classifier(jax.random.PRNGKey(seed), dim, num_classes)
    lengths = J_tr._stack_node_data(X, y, idx).lengths
    draw = jax.vmap(lambda k, length: jax.random.randint(
        k, (batch_size,), 0, jnp.maximum(length, 1)))
    key = jax.random.PRNGKey(seed + 1)
    batches = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(draw(jax.random.split(sub, n), lengths)))
    return {k: np.asarray(v) for k, v in params0.items()}, np.stack(batches)


def test_online_classification_matches_reference_on_its_draws():
    X, y = gaussian_blobs(n_samples=480, num_classes=4, dim=8, seed=0)
    X_tr, y_tr, X_te, y_te = X[:400], y[:400], X[400:], y[400:]
    n, K, steps, batch = 8, 4, 31, 8
    idx, Pi = cluster_partition(y_tr, n)
    labels = labels_stream(
        AbruptLabelSwap(Pi, t_drift=10, node_perm=np.random.default_rng(6).permutation(n)),
        steps, 16, seed=0)
    ctl, j_ctl = _controllers(Pi, budget0=2, budget=4)
    params0, batch_idx = _reference_draws(X_tr, y_tr, idx, steps, batch, seed=0)
    kw = dict(steps=steps, batch_size=batch, lr=0.3, eval_every=5, X_test=X_te, y_test=y_te,
              seed=0)
    logs = {}
    for rollout in ("scan", "loop"):
        c, _ = _controllers(Pi, budget0=2, budget=4) if rollout == "loop" else (ctl, None)
        logs[rollout] = T_tr.run_classification(
            X_tr, y_tr, idx, None, schedule=c.schedule_arrays(), on_segment=_feeding_hook(c, labels),
            rollout=rollout, device="cpu", params0=params0, batch_indices=batch_idx, **kw)
    ref = J_tr.run_classification(
        X_tr, y_tr, idx, None, schedule=j_ctl.schedule_arrays(),
        on_segment=_feeding_hook(j_ctl, labels), **kw)
    port = logs["scan"]
    assert port.aux["swaps"] == ref.aux["swaps"] and port.aux["swaps"]
    assert [r["step"] for r in port.history] == [r["step"] for r in ref.history]
    np.testing.assert_allclose(port.column("loss"), ref.column("loss"), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.column("acc_mean"), ref.column("acc_mean"), atol=0.02)
    assert port.aux["comm"] == ref.aux["comm"]
    # segments of 1 and 6 x 5 steps: only the 5-step body recurs
    assert port.aux["n_traces"] == 1 and logs["loop"].aux["n_traces"] == 1
    assert np.array_equal(logs["loop"].column("loss"), port.column("loss"))


def _arrays(Pi, budget, l_max, lam=0.5):
    return schedule_to_arrays(schedule_from_result(learn_topology(Pi, budget=budget, lam=lam)),
                              l_max=l_max, device="cpu")


@pytest.mark.parametrize("form", ["W", "schedule", "arrays-swap"])
def test_scan_is_bitwise_the_loop_on_the_cpu(form):
    n = 12
    task = mean_estimation_clusters(n_nodes=n, K=4, m=3.0)
    Pi = _one_hot_pi(n, 4)
    res = learn_topology(Pi, budget=4, lam=0.5)
    kw = dict(steps=30, lr=0.2, seed=1, device="cpu")
    if form == "W":
        kw.update(W=res.W)
    elif form == "schedule":
        kw.update(W=None, schedule=schedule_from_result(res))
    else:
        sa2 = _arrays(Pi[::-1].copy(), 4, 8)
        kw.update(W=None, schedule=_arrays(Pi, 4, 8), segment_len=5,
                  on_segment=lambda t: sa2 if t == 14 else None)
    outs = {r: T_tr.run_mean_estimation(task, rollout=r, **kw) for r in ("scan", "loop")}
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
        assert np.array_equal(outs["scan"][key], outs["loop"][key]), key
    if form == "arrays-swap":
        assert outs["scan"]["swaps"] == outs["loop"]["swaps"] == [14]

    X, y = gaussian_blobs(n_samples=300, num_classes=4, dim=8, seed=0)
    idx, _ = cluster_partition(y, n)
    ckw = dict(model="mlp", hidden=8, steps=23, batch_size=8, lr=0.3, eval_every=5,
               X_test=X[:50], y_test=y[:50], seed=3, device="cpu")
    if form == "W":
        ckw.update(W=res.W)
    elif form == "schedule":
        ckw.update(W=None, schedule=schedule_from_result(res))
    else:
        sa2 = _arrays(Pi[::-1].copy(), 4, 8)
        ckw.update(W=None, schedule=_arrays(Pi, 4, 8),
                   on_segment=lambda t: sa2 if t == 10 else None)
    logs = {r: T_tr.run_classification(X, y, idx, rollout=r, **ckw) for r in ("scan", "loop")}
    assert logs["scan"].history == logs["loop"].history
    assert logs["scan"].aux["swaps"] == logs["loop"].aux["swaps"]


def test_swap_to_another_l_max_counts_one_capture():
    n = 12
    task = mean_estimation_clusters(n_nodes=n, K=4, m=3.0)
    Pi = _one_hot_pi(n, 4)
    sa_small, sa_same, sa_big = _arrays(Pi, 3, 6), _arrays(Pi[::-1].copy(), 3, 6), _arrays(Pi, 4, 9)
    swaps_at = {4: sa_same, 14: sa_big}
    guard = RetraceGuard()
    port = T_tr.run_mean_estimation(
        task, None, steps=30, schedule=sa_small, segment_len=5, seed=0, rollout="scan",
        on_segment=lambda t: swaps_at.get(t), retrace_guard=guard, device="cpu")
    assert port["swaps"] == [4, 14]
    assert port["n_traces"] == 2 and guard.counts == {"mean_estimation.roll": 2}
    # the reference retraces once for the new l_max, and never for a same-shape swap
    j = {l: J_mix.schedule_to_arrays(J_mix.schedule_from_result(j_learn(P, budget=b, lam=0.5)),
                                     l_max=l)
         for l, P, b in ((6, Pi, 3), (9, Pi, 4))}
    j_same = J_mix.schedule_to_arrays(
        J_mix.schedule_from_result(j_learn(Pi[::-1].copy(), budget=3, lam=0.5)), l_max=6)
    j_swaps = {4: j_same, 14: j[9]}
    ref = J_tr.run_mean_estimation(task, None, steps=30, schedule=j[6], segment_len=5, seed=0,
                                   on_segment=lambda t: j_swaps.get(t))
    assert ref["n_traces"] == port["n_traces"]
    np.testing.assert_allclose(port["mean_sq_error"], ref["mean_sq_error"], rtol=1e-6, atol=1e-6)


def test_long_segments_run_as_bounded_bodies():
    assert T_roll.MAX_GRAPH_STEPS == 64
    assert T_roll.chunks(150) == [64, 64, 22] and T_roll.chunks(64) == [64]
    n = 6
    X, y = gaussian_blobs(n_samples=120, num_classes=3, dim=4, seed=0)
    idx, _ = cluster_partition(y, n)
    kw = dict(steps=150, batch_size=4, lr=0.2, seed=0, device="cpu")  # no eval: one segment
    logs = {r: T_tr.run_classification(X, y, idx, T.ring(n), rollout=r, **kw)
            for r in ("scan", "loop")}
    assert logs["scan"].aux["n_traces"] == 1  # the 64-step body recurs, the 22-step one not
    assert logs["loop"].aux["n_traces"] == 1
    assert logs["scan"].history == logs["loop"].history
    assert len(logs["scan"].history) == 150


def test_scan_validates_like_the_reference():
    task = mean_estimation_clusters(n_nodes=4, K=2, m=1.0)
    Pi = _one_hot_pi(4, 2)
    with pytest.raises(ValueError, match="rollout"):
        T_tr.run_mean_estimation(task, T.complete(4), steps=2, rollout="graph", device="cpu")
    with pytest.raises(ValueError, match="ScheduleArrays"):
        T_tr.run_mean_estimation(task, T.complete(4), steps=4, on_segment=lambda t: None,
                                 rollout="scan", device="cpu")
    with pytest.raises(ValueError, match="segment_len"):
        T_tr.run_mean_estimation(task, None, schedule=_arrays(Pi, 1, 3), steps=4,
                                 segment_len=0, rollout="scan", device="cpu")
    with pytest.raises(TypeError):
        T_tr.run_mean_estimation(task, None, schedule=_arrays(Pi, 1, 3), steps=4,
                                 segment_len=2, on_segment=lambda t: "W", device="cpu")
