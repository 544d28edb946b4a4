"""The port's mixing transports and D-SGD step against the reference's.

The same numpy inputs go through ``repro.core.mixing`` / ``repro.core.dsgd``
(JAX, on the CPU) and their counterparts in ``repro_torch`` (the plain
PyTorch path on the CPU). Both packages run float32 arithmetic; sums over
the node axis may be taken in another order, so results are held to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dsgd as J_dsgd  # noqa: E402
from repro.core import mixing as J_mix  # noqa: E402
from repro.train import metrics as J_metrics  # noqa: E402
from repro_torch.core import dsgd as T_dsgd  # noqa: E402
from repro_torch.core import mixing as T_mix  # noqa: E402
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.kernels.gossip_mix import ops  # noqa: E402
from repro_torch.train import metrics as T_metrics  # noqa: E402

TOL = 1e-6
SHAPES = {"w1": (7, 5), "b1": (5,), "w2": (5, 3), "b2": (3,)}


def _topology(n: int):
    labels = np.random.default_rng(n).integers(0, 10, size=30 * n)
    Pi = dirichlet_partition(labels, n, alpha=0.3, seed=0)[1]
    res = learn_topology(Pi, budget=min(4, n), lam=0.1)
    return res.W.astype(np.float32), res


def _tree(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in SHAPES.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _assert_tree_close(port, ref, tol=TOL):
    port_leaves = port if isinstance(port, dict) else {"x": port}
    ref_leaves = ref if isinstance(ref, dict) else {"x": ref}
    assert sorted(port_leaves) == sorted(ref_leaves)
    for k in ref_leaves:
        np.testing.assert_allclose(port_leaves[k].numpy(), np.asarray(ref_leaves[k]),
                                   atol=tol, rtol=tol)


def _schedules(res):
    j = J_mix.schedule_from_result(res)
    t = T_mix.schedule_from_result(res)
    assert j.coeffs == t.coeffs and j.perms == t.perms
    return j, t


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [8, 33])
def test_mix_stacked_dense(n, use_kernel):
    W, _ = _topology(n)
    j, t = _both(_tree(n))
    ref = J_mix.mix_stacked(j, W=jnp.asarray(W), transport="dense", use_kernel=use_kernel)
    port = T_mix.mix_stacked(t, W=torch.from_numpy(W), transport="dense", use_kernel=use_kernel)
    _assert_tree_close(port, ref)


@pytest.mark.parametrize("single_buffer", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n", [8, 33])
def test_mix_stacked_schedule(n, use_kernel, single_buffer):
    _, res = _topology(n)
    js, ts = _schedules(res)
    j, t = _both(_tree(n, seed=1))
    ref = J_mix.mix_stacked(j, schedule=js, transport="schedule", use_kernel=use_kernel,
                            single_buffer=single_buffer)
    port = T_mix.mix_stacked(t, schedule=ts, transport="schedule", use_kernel=use_kernel,
                             single_buffer=single_buffer)
    _assert_tree_close(port, ref)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pad", [0, 3])
def test_mix_stacked_schedule_arrays(pad, use_kernel):
    n = 33
    _, res = _topology(n)
    js, ts = _schedules(res)
    ja = J_mix.schedule_to_arrays(js, l_max=js.n_atoms + pad)
    ta = T_mix.schedule_to_arrays(ts, l_max=ts.n_atoms + pad, device="cpu")
    assert np.array_equal(np.asarray(ja.gammas), ta.gammas.numpy())
    assert np.array_equal(np.asarray(ja.perms), ta.perms.numpy())
    assert np.array_equal(J_mix.arrays_to_matrix(ja), T_mix.arrays_to_matrix(ta))
    j, t = _both(_tree(n, seed=2))
    ref = J_mix.mix_stacked(j, schedule=ja, use_kernel=use_kernel)
    port = T_mix.mix_stacked(t, schedule=ta, use_kernel=use_kernel)
    _assert_tree_close(port, ref)
    with pytest.raises(ValueError):
        T_mix.mix_stacked(t, W=torch.eye(n), schedule=ta, transport="dense")


def test_auto_transport_picks_as_the_reference():
    n = 33
    W, res = _topology(n)
    js, ts = _schedules(res)
    for L in range(1, n + 1):
        assert T_mix.preferred_transport(n, L) == J_mix.preferred_transport(n, L)
    j, t = _both(_tree(n, seed=3))
    ref = J_mix.mix_stacked(j, W=jnp.asarray(W), schedule=js)
    port = T_mix.mix_stacked(t, W=torch.from_numpy(W), schedule=ts)
    _assert_tree_close(port, ref)
    with pytest.raises(NotImplementedError):
        T_mix.mix_stacked(t, W=torch.from_numpy(W), schedule=ts, transport="autotune")


def test_mix_dense_densifies_schedule_without_w():
    _, res = _topology(8)
    js, ts = _schedules(res)
    j, t = _both(_tree(8, seed=4))
    _assert_tree_close(T_mix.mix_stacked(t, schedule=ts, transport="dense"),
                       J_mix.mix_stacked(j, schedule=js, transport="dense"))


@pytest.mark.parametrize("pad_to", [None, 8, 64])
def test_ravel_unravel_round_trip(pad_to):
    n = 5
    tree = _tree(n, seed=5)
    j, t = _both(tree)
    jflat, jspec = J_mix.ravel_stack(j, pad_to=pad_to)
    tflat, tspec = T_mix.ravel_stack(t, pad_to=pad_to)
    # the same layout: leaves in sorted key order, zero padding at the end
    assert np.array_equal(np.asarray(jflat), tflat.numpy())
    assert (tspec.total, tspec.padded) == (jspec.total, jspec.padded)
    back = T_mix.unravel_stack(tflat, tspec)
    for k, v in tree.items():
        assert back[k].shape == v.shape and back[k].dtype == torch.float32
        assert np.array_equal(back[k].numpy(), v)


def test_ravel_mixed_dtypes_and_single_tensor():
    t = {"a": torch.ones((3, 2), dtype=torch.bfloat16), "b": torch.arange(3.0).reshape(3, 1)}
    flat, spec = T_mix.ravel_stack(t)
    assert flat.dtype == torch.float32 and flat.shape == (3, 3)
    back = T_mix.unravel_stack(flat, spec)
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["b"], t["b"])
    x = torch.randn(4, 2, 3)
    flat, spec = T_mix.ravel_stack(x, pad_to=8)
    assert flat.shape == (4, 8) and torch.equal(T_mix.unravel_stack(flat, spec), x)
    with pytest.raises(ValueError):
        T_mix.ravel_stack({"a": torch.ones(3, 2), "b": torch.ones(4, 2)})


def test_truncate_and_schedule_from_matrix_equal():
    W, res = _topology(33)
    js, ts = _schedules(res)
    jt, tt = J_mix.truncate_schedule(js, 3), T_mix.truncate_schedule(ts, 3)
    assert jt.coeffs == tt.coeffs and jt.perms == tt.perms
    jm, tm = J_mix.schedule_from_matrix(res.W), T_mix.schedule_from_matrix(res.W)
    assert jm.coeffs == tm.coeffs and jm.perms == tm.perms
    assert np.array_equal(tm.to_matrix(), jm.to_matrix())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("transport", ["dense", "schedule"])
def test_dsgd_step_stacked(transport, momentum):
    n = 8
    W, res = _topology(n)
    js, ts = _schedules(res)
    j, t = _both(_tree(n, seed=6))
    js_state = J_dsgd.dsgd_init(j, momentum=momentum)
    ts_state = T_dsgd.dsgd_init(t, momentum=momentum)
    for step in range(4):
        gj, gt = _both(_tree(n, seed=10 + step))
        j, js_state = J_dsgd.dsgd_step_stacked(
            j, gj, js_state, jnp.asarray(W), 0.1, momentum=momentum,
            schedule=js, transport=transport)
        t, ts_state = T_dsgd.dsgd_step_stacked(
            t, gt, ts_state, torch.from_numpy(W), 0.1, momentum=momentum,
            schedule=ts, transport=transport)
        _assert_tree_close(t, j)
        if momentum:
            _assert_tree_close(ts_state.momentum, js_state.momentum)
    assert ts_state.step == int(js_state.step) == 4


def test_dsgd_step_matches_manual_and_refuses_ef():
    n, d = 6, 5
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    grads = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    W, _ = _topology(n)
    new, state = T_dsgd.dsgd_step_stacked(theta, grads, T_dsgd.dsgd_init(theta),
                                          torch.from_numpy(W), 0.1)
    manual = W @ (theta.numpy() - 0.1 * grads.numpy())
    np.testing.assert_allclose(new.numpy(), manual, atol=TOL)
    # an EF memory needs the ScheduleArrays data plane, not a dense W
    with pytest.raises(ValueError, match="ScheduleArrays"):
        T_dsgd.dsgd_step_stacked(theta, grads, state, torch.from_numpy(W), 0.1, ef=theta)


def test_mixing_on_cpu_launches_no_kernel():
    ops.reset_launch_counts()
    W, res = _topology(8)
    _, ts = _schedules(res)
    _, t = _both(_tree(8))
    T_mix.mix_stacked(t, W=torch.from_numpy(W), transport="dense", use_kernel=True)
    T_mix.mix_stacked(t, schedule=ts, use_kernel=True)
    assert ops.launch_counts == {"gossip_schedule": 0, "gossip_mix": 0}


def test_metrics_match_reference():
    j, t = _both(_tree(8, seed=7))
    np.testing.assert_allclose(float(T_metrics.consensus_distance(t)),
                               float(J_metrics.consensus_distance(j)), rtol=1e-6)
    v = np.array([0.2, 0.5, 0.9])
    assert T_metrics.node_spread(torch.from_numpy(v)) == J_metrics.node_spread(v)
    log = T_metrics.MetricLogger()
    log.log(0, loss=1.0)
    log.log(1, loss=0.5, acc_mean=0.7)
    assert np.array_equal(log.column("acc_mean"), [0.7])
    assert np.isnan(log.column("acc_mean", aligned=True)[0])
