"""Bounded-delay, straggler and corrupted gossip (``repro_torch.core.mixing``)
against the reference's ``repro.core.mixing``.

The ring, the policies and the wire corruption are exact operations (a
gather, a numpy repair, a bit pattern XOR), so they are compared exactly;
the mixes and the screen statistics are float32 sums, held to 1e-6
relative. Zero delays must give the fresh transport bitwise, and the
repaired W must stay doubly stochastic to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.mixing as J_mix  # noqa: E402
from repro.data.synthetic import mean_estimation_clusters as j_mec  # noqa: E402
from repro.train import metrics as J_metrics  # noqa: E402
from repro.train import trainer as J_tr  # noqa: E402

from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import cluster_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.train import metrics as T_metrics  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402

RTOL = 1e-6


def _atoms(n, L, seed):
    rng = np.random.default_rng(seed)
    g = rng.dirichlet(np.ones(L)).astype(np.float32)
    p = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)]).astype(np.int32)
    return (T_mix.ScheduleArrays(torch.from_numpy(g), torch.from_numpy(p)),
            J_mix.ScheduleArrays(jnp.asarray(g), jnp.asarray(p)))


def _dense_w(arrays) -> np.ndarray:
    """W from (gammas, perms), gammas renormalized in float64 (the
    reference bench's ``_dense_w``)."""
    gam = np.asarray(arrays.gammas, np.float64)
    gam = gam / gam.sum()
    per = np.asarray(arrays.perms, np.int64)
    n = per.shape[1]
    W = np.zeros((n, n))
    for l in range(per.shape[0]):
        W[np.arange(n), per[l]] += gam[l]
    return W


def test_ring_push_and_view_match_reference():
    n, P, depth = 6, 4, 3
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(n, P)).astype(np.float32)
    t_buf = T_mix.stale_buffer_init(torch.from_numpy(x0), depth)
    j_buf = J_mix.stale_buffer_init(jnp.asarray(x0), depth)
    for _ in range(5):
        x = rng.normal(size=(n, P)).astype(np.float32)
        T_mix.stale_push(t_buf, torch.from_numpy(x))
        j_buf = J_mix.stale_push(j_buf, jnp.asarray(x))
        assert int(t_buf.head) == int(j_buf.head)
        assert np.array_equal(t_buf.buf.numpy(), np.asarray(j_buf.buf))
        d = rng.integers(0, depth, n).astype(np.int32)
        assert np.array_equal(T_mix.stale_view(t_buf, torch.from_numpy(d)).numpy(),
                              np.asarray(J_mix.stale_view(j_buf, jnp.asarray(d))))
    with pytest.raises(ValueError, match="depth"):
        T_mix.stale_buffer_init(torch.from_numpy(x0), 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degrade_schedule_matches_reference_and_stays_doubly_stochastic(seed):
    n, L = 10, 5
    t_sa, j_sa = _atoms(n, L, seed)
    rng = np.random.default_rng(seed + 10)
    alive = rng.random(n) > 0.3
    edges = np.argwhere((rng.random((n, n)) < 0.15) & ~np.eye(n, dtype=bool))
    port = T_mix.degrade_schedule(t_sa, alive, edges)
    ref = J_mix.degrade_schedule(j_sa, alive, edges)
    assert np.array_equal(port.perms.numpy(), np.asarray(ref.perms))
    assert np.array_equal(port.gammas.numpy(), np.asarray(ref.gammas))
    W = _dense_w(port)
    assert np.abs(W.sum(axis=0) - 1).max() <= 1e-12 and np.abs(W.sum(axis=1) - 1).max() <= 1e-12
    for i in np.flatnonzero(~alive):  # a dead node is isolated to e_i
        assert abs(W[i, i] - 1.0) <= 1e-12
    everyone = T_mix.degrade_schedule(t_sa, np.ones(n, bool))
    assert torch.equal(everyone.perms, t_sa.perms)


@pytest.mark.parametrize("mode", ["wait", "degrade"])
def test_straggler_stream_matches_reference(mode):
    n, L, T = 8, 4, 12
    t_sa, j_sa = _atoms(n, L, 3)
    rng = np.random.default_rng(4)
    delays = rng.integers(0, 5, (T, n))
    alive = rng.random((T, n)) > 0.1

    def edges_at(t):
        return np.array([[t % n, (t + 1) % n]])

    port = T_mix.straggler_stream(T_mix.StragglerPolicy(mode, 2), t_sa, delays, alive, edges_at)
    ref = J_mix.straggler_stream(J_mix.StragglerPolicy(mode, 2), j_sa, delays, alive, edges_at)
    for p, r in zip(port, ref):
        assert p.dtype == {np.float32: torch.float32, np.int32: torch.int32}[np.asarray(r).dtype.type]
        assert np.array_equal(p.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="mode"):
        T_mix.StragglerPolicy("drop", 1)
    assert T_mix.StragglerPolicy("wait", 3).ring_depth == 4


@pytest.mark.parametrize("use_kernel", [False, True])
def test_zero_delays_are_fresh_mixing_bitwise(use_kernel):
    n, P = 12, 7
    t_sa, _ = _atoms(n, 5, 5)
    rng = np.random.default_rng(6)
    buf = T_mix.stale_buffer_init(torch.from_numpy(rng.normal(size=(n, P)).astype(np.float32)), 4)
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(n, P)).astype(np.float32))
        T_mix.stale_push(buf, x)
        zero = torch.zeros(n, dtype=torch.int32)
        stale = T_mix.mix_schedule_arrays_stale(buf, t_sa, zero, use_kernel=use_kernel)
        assert torch.equal(stale, T_mix.mix_schedule_arrays(x, t_sa, use_kernel=use_kernel))
        honest = T_mix.WireCorruption(torch.ones(n), torch.zeros(n, dtype=torch.int32))
        assert torch.equal(T_mix.mix_schedule_arrays_stale(buf, t_sa, zero, honest), stale)
        screened, _ = T_mix.mix_schedule_arrays_screened(buf, t_sa, zero, x, honest)
        assert torch.equal(screened, stale)


_MODES = {
    "nan": (np.float32(np.nan), np.int32(0)),
    "sign_flip": (np.float32(-1.0), np.int32(0)),
    "scale:8": (np.float32(8.0), np.int32(0)),
    "bitflip": (np.float32(1.0), np.int32(1) << np.int32(25)),
}


def _corruption(n, mode, liars=(1, 4)):
    mult, xor = np.ones(n, np.float32), np.zeros(n, np.int32)
    mult[list(liars)], xor[list(liars)] = _MODES[mode]
    return (T_mix.WireCorruption(torch.from_numpy(mult), torch.from_numpy(xor)),
            J_mix.WireCorruption(jnp.asarray(mult), jnp.asarray(xor)))


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_corrupt_wire_is_bitwise_the_reference(mode):
    n, P = 6, 5
    x = np.random.default_rng(7).normal(size=(n, P)).astype(np.float32)
    t_c, j_c = _corruption(n, mode)
    port = T_mix.corrupt_wire(torch.from_numpy(x), t_c).numpy()
    ref = np.asarray(J_mix.corrupt_wire(jnp.asarray(x), j_c))
    assert np.array_equal(port.view(np.int32), ref.view(np.int32))
    honest = np.setdiff1d(np.arange(n), [1, 4])
    assert np.array_equal(port[honest].view(np.int32), x[honest].view(np.int32))
    with pytest.raises(ValueError, match="float32"):
        T_mix.corrupt_wire(torch.from_numpy(x).double(), t_c)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("guard", [True, False])
def test_screened_mix_and_stats_match_reference(mode, guard):
    n, P, depth = 8, 5, 3
    t_sa, j_sa = _atoms(n, 4, 8)
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=(n, P)).astype(np.float32)
    t_buf = T_mix.stale_buffer_init(torch.from_numpy(x0), depth)
    j_buf = J_mix.stale_buffer_init(jnp.asarray(x0), depth)
    own = rng.normal(size=(n, P)).astype(np.float32)
    T_mix.stale_push(t_buf, torch.from_numpy(own))
    j_buf = J_mix.stale_push(j_buf, jnp.asarray(own))
    d = rng.integers(0, depth, n).astype(np.int32)
    t_c, j_c = _corruption(n, mode)
    pm, ps = T_mix.mix_schedule_arrays_screened(t_buf, t_sa, torch.from_numpy(d),
                                                torch.from_numpy(own), t_c, guard=guard)
    rm, rs = J_mix.mix_schedule_arrays_screened(j_buf, j_sa, jnp.asarray(d), jnp.asarray(own),
                                                j_c, guard=guard)
    np.testing.assert_allclose(pm.numpy(), np.asarray(rm), rtol=RTOL, atol=1e-6)
    assert np.array_equal(ps.finite.numpy(), np.asarray(rs.finite))
    for field in ("sq_own", "sq_recv", "dot"):
        np.testing.assert_allclose(getattr(ps, field).numpy(), np.asarray(getattr(rs, field)),
                                   rtol=RTOL, atol=1e-6)
    # the corrupted transport without the screen, per leaf and raveled
    flat = rng.normal(size=(n, P)).astype(np.float32)
    ref = np.asarray(J_mix.mix_schedule_arrays(jnp.asarray(flat), j_sa, corrupt=j_c))
    for single in (False, True):
        port = T_mix.mix_schedule_arrays(torch.from_numpy(flat), t_sa, corrupt=t_c,
                                         single_buffer=single).numpy()
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-6)


def test_staleness_transfer_fracs_match_reference():
    rng = np.random.default_rng(10)
    for _ in range(5):
        d = rng.integers(0, 6, 9)
        for mode in ("wait", "degrade"):
            assert (T_metrics.staleness_transfer_fracs(d, 3, mode)
                    == J_metrics.staleness_transfer_fracs(d, 3, mode))
    with pytest.raises(ValueError, match="mode"):
        T_metrics.staleness_transfer_fracs(np.zeros(3), 1, "drop")


def _arrays(Pi, budget, l_max):
    res = learn_topology(Pi, budget=budget, lam=0.5)
    return T_mix.schedule_to_arrays(T_mix.schedule_from_result(res), l_max=l_max, device="cpu")


def _j(sa):
    return J_mix.ScheduleArrays(jnp.asarray(sa.gammas.numpy()), jnp.asarray(sa.perms.numpy()))


@pytest.mark.parametrize("mode,compression", [("wait", None), ("degrade", None),
                                              ("wait", "bf16"), ("degrade", "topk:0.5:g0.5")])
def test_mean_estimation_under_staleness_matches_reference(mode, compression):
    n, K, steps, seg = 12, 4, 30, 5
    task = mean_estimation_clusters(n_nodes=n, K=K, m=3.0)
    Pi = np.eye(K)[np.arange(n) % K]
    sa, sa2 = _arrays(Pi, 4, 8), _arrays(Pi[::-1].copy(), 4, 8)
    delays = np.random.default_rng(11).integers(0, 5, (steps, n)).astype(np.int32)
    kw = dict(steps=steps, lr=0.2, seed=1, segment_len=seg, delays=delays,
              compression=compression)
    port = {r: T_tr.run_mean_estimation(task, None, schedule=sa, device="cpu", rollout=r,
                                        staleness=T_mix.StragglerPolicy(mode, 2),
                                        on_segment=lambda t: sa2 if t == 14 else None, **kw)
            for r in ("scan", "loop")}
    ref = J_tr.run_mean_estimation(j_mec(n_nodes=n, K=K, m=3.0), None, schedule=_j(sa),
                                   staleness=J_mix.StragglerPolicy(mode, 2),
                                   on_segment=lambda t: _j(sa2) if t == 14 else None, **kw)
    tol = 3e-2 if compression == "bf16" else RTOL
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
        np.testing.assert_allclose(port["scan"][key], ref[key], rtol=tol, atol=1e-6)
        assert np.array_equal(port["scan"][key], port["loop"][key])
    for key in ("swaps", "comm", "compression", "staleness"):
        assert port["scan"][key] == ref[key], key
    assert port["scan"]["n_traces"] == 1


def test_zero_delays_are_the_fresh_drivers_bitwise():
    n, K, steps = 12, 4, 24
    task = mean_estimation_clusters(n_nodes=n, K=K, m=3.0)
    Pi = np.eye(K)[np.arange(n) % K]
    sa, sa2 = _arrays(Pi, 4, 8), _arrays(Pi[::-1].copy(), 4, 8)
    kw = dict(steps=steps, lr=0.2, seed=1, segment_len=6, device="cpu",
              on_segment=lambda t: sa2 if t == 11 else None)
    fresh = T_tr.run_mean_estimation(task, None, schedule=sa, **kw)
    for mode in ("wait", "degrade"):
        stale = T_tr.run_mean_estimation(task, None, schedule=sa,
                                         staleness=T_mix.StragglerPolicy(mode, 4), **kw)
        for key in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
            assert np.array_equal(stale[key], fresh[key]), (mode, key)
        assert stale["comm"]["total_bytes"] == fresh["comm"]["total_bytes"]
        assert stale["comm"]["deferred_bytes"] == stale["comm"]["dropped_bytes"] == 0
    X, y = gaussian_blobs(n_samples=300, num_classes=4, dim=8, seed=0)
    idx, Pi8 = cluster_partition(y, 8)
    sb, sb2 = _arrays(Pi8, 3, 6), _arrays(Pi8[::-1].copy(), 3, 6)
    ckw = dict(model="mlp", hidden=8, steps=23, batch_size=8, lr=0.3, eval_every=5,
               X_test=X[:50], y_test=y[:50], seed=3, device="cpu",
               on_segment=lambda t: sb2 if t == 10 else None)
    fresh = T_tr.run_classification(X, y, idx, None, schedule=sb, **ckw)
    stale = T_tr.run_classification(X, y, idx, None, schedule=sb,
                                    staleness=T_mix.StragglerPolicy("wait", 2), **ckw)
    assert stale.history == fresh.history
    assert stale.aux["comm"]["total_bytes"] == fresh.aux["comm"]["total_bytes"]
    assert stale.aux["swaps"] == fresh.aux["swaps"] == [10]


def test_classification_under_staleness_matches_reference_on_its_draws():
    import jax

    X, y = gaussian_blobs(n_samples=480, num_classes=4, dim=8, seed=0)
    X_tr, y_tr, X_te, y_te = X[:400], y[:400], X[400:], y[400:]
    n, steps, batch = 8, 11, 8
    idx, Pi = cluster_partition(y_tr, n)
    sa = _arrays(Pi, 3, 6)
    params0 = J_tr.init_mlp_classifier(jax.random.PRNGKey(0), X.shape[1], 4, 8)
    lengths = J_tr._stack_node_data(X_tr, y_tr, idx).lengths
    draw = jax.vmap(lambda k, length: jax.random.randint(k, (batch,), 0, jnp.maximum(length, 1)))
    key, batches = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(draw(jax.random.split(sub, n), lengths)))
    delays = np.random.default_rng(12).integers(0, 4, (steps, n)).astype(np.int32)
    kw = dict(model="mlp", hidden=8, steps=steps, batch_size=batch, lr=0.3, eval_every=5,
              X_test=X_te, y_test=y_te, seed=0, delays=delays, compression="topk:0.5")
    port = T_tr.run_classification(X_tr, y_tr, idx, None, schedule=sa, device="cpu",
                                   staleness=T_mix.StragglerPolicy("wait", 2),
                                   params0={k: np.asarray(v) for k, v in params0.items()},
                                   batch_indices=np.stack(batches), **kw)
    ref = J_tr.run_classification(X_tr, y_tr, idx, None, schedule=_j(sa),
                                  staleness=J_mix.StragglerPolicy("wait", 2), **kw)
    # float32 reductions in another order than XLA's (as in test_torch_trainer.py)
    np.testing.assert_allclose(port.column("loss"), ref.column("loss"), rtol=1e-4, atol=1e-5)
    for key in ("comm", "compression", "staleness"):
        assert port.aux[key] == ref.aux[key], key


def test_staleness_arguments_are_checked_as_the_reference_checks_them():
    n = 4
    task = mean_estimation_clusters(n_nodes=n, K=2, m=1.0)
    sa = _arrays(np.eye(2)[np.arange(n) % 2], 2, 4)
    policy = T_mix.StragglerPolicy("wait", 1)
    cases = [
        (dict(schedule=sa, delays=np.zeros((4, n))), ValueError, "delays without staleness"),
        (dict(schedule=sa, staleness="wait"), TypeError, "StragglerPolicy"),
        (dict(W=np.eye(n), staleness=policy), ValueError, "data plane"),
        (dict(schedule=sa, staleness=policy, delays=np.zeros((3, n))), ValueError,
         "delays must be"),
        (dict(schedule=sa, staleness=policy, delays=-np.ones((4, n))), ValueError,
         "non-negative"),
    ]
    for kw, exc, match in cases:
        kw.setdefault("W", None)
        with pytest.raises(exc, match=match):
            T_tr.run_mean_estimation(task, steps=4, device="cpu", **kw)
