"""The port's D-SGD simulator against the reference's.

Mean estimation presamples its noise with numpy from ``seed`` in both
packages, so the error traces are held to 1e-6. Classification draws its
initial parameters and minibatch indices with ``jax.random`` in the
reference and with ``torch.Generator``s in the port, which give other
numbers: the parity tests replay the reference's draws
(``repro/train/trainer.py:803-818, 834-835``) and hand them to the port
through its ``params0`` / ``batch_indices`` seams. The port's own random
path is held to analogues of ``tests/test_trainer_convergence.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import mixing as J_mix  # noqa: E402
from repro.train import trainer as J_tr  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.mixing import (  # noqa: E402
    PoolSwap,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import shard_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402


def _mean_estimation_setup(n=20, K=4, m=2.0, budget=3):
    task = mean_estimation_clusters(n, K=K, m=m)
    res = learn_topology(task.Pi, budget=budget, lam=0.5)
    return task, res


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("form", ["W", "schedule", "arrays"])
def test_mean_estimation_matches_reference(form, batch):
    task, res = _mean_estimation_setup()
    kw = dict(steps=20, lr=0.2, batch=batch, seed=3)
    if form == "W":
        ref = J_tr.run_mean_estimation(task, res.W, **kw)
        port = T_tr.run_mean_estimation(task, res.W, device="cpu", **kw)
    elif form == "schedule":
        ref = J_tr.run_mean_estimation(task, None, schedule=J_mix.schedule_from_result(res), **kw)
        port = T_tr.run_mean_estimation(task, None, schedule=schedule_from_result(res),
                                        device="cpu", **kw)
    else:
        ja = J_mix.schedule_to_arrays(J_mix.schedule_from_result(res), l_max=6)
        ref = J_tr.run_mean_estimation(task, None, schedule=ja, **kw)
        ta = schedule_to_arrays(schedule_from_result(res), l_max=6, device="cpu")
        port = T_tr.run_mean_estimation(task, None, schedule=ta, device="cpu", **kw)
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error"):
        assert port[key].shape == (20,)
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port["theta"], ref["theta"], rtol=1e-6, atol=1e-6)


def test_mean_estimation_explicit_zs_and_kernel_numerics():
    task, res = _mean_estimation_setup()
    zs = np.random.default_rng(9).normal(size=(15, 20, 2))
    sched = schedule_from_result(res)
    ref = J_tr.run_mean_estimation(task, None, schedule=J_mix.schedule_from_result(res),
                                   steps=15, zs=zs, use_kernel=True)
    for use_kernel in (False, True):
        port = T_tr.run_mean_estimation(task, None, schedule=sched, steps=15, zs=zs,
                                        use_kernel=use_kernel, device="cpu")
        np.testing.assert_allclose(port["mean_sq_error"], ref["mean_sq_error"],
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        T_tr.run_mean_estimation(task, res.W, steps=14, zs=zs, device="cpu")


def _reference_draws(X, y, idx, model, steps, batch_size, seed, hidden=16):
    """Replay the reference's jax.random draws: the init params and the
    (steps, n, batch) minibatch indices of its run_classification."""
    n, dim, num_classes = len(idx), X.shape[1], int(y.max()) + 1
    rng = jax.random.PRNGKey(seed)
    if model == "linear":
        params0 = J_tr.init_linear_classifier(rng, dim, num_classes)
    else:
        params0 = J_tr.init_mlp_classifier(rng, dim, num_classes, hidden)
    lengths = J_tr._stack_node_data(X, y, idx).lengths
    draw = jax.vmap(lambda k, length: jax.random.randint(
        k, (batch_size,), 0, jnp.maximum(length, 1)))
    key = jax.random.PRNGKey(seed + 1)
    batches = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(draw(jax.random.split(sub, n), lengths)))
    return {k: np.asarray(v) for k, v in params0.items()}, np.stack(batches)


def _classification_data(n=12, n_samples=1200, dim=16):
    X, y = gaussian_blobs(n_samples, 10, dim=dim, sep=2.5, seed=1)
    X_tr, y_tr = X[:1000], y[:1000]
    idx, Pi = shard_partition(y_tr, n, seed=0)
    return X_tr, y_tr, X[1000:], y[1000:], idx, Pi


@pytest.mark.parametrize("transport", ["dense", "schedule"])
@pytest.mark.parametrize("model", ["linear", "mlp"])
def test_classification_matches_reference_on_its_draws(model, transport):
    X, y, X_te, y_te, idx, Pi = _classification_data()
    res = learn_topology(Pi, budget=3, lam=0.1)
    steps, batch = 12, 16
    params0, batch_idx = _reference_draws(X, y, idx, model, steps, batch, seed=2)
    kw = dict(model=model, hidden=16, steps=steps, batch_size=batch, lr=0.3,
              eval_every=5, X_test=X_te, y_test=y_te, seed=2)
    if transport == "dense":
        ref = J_tr.run_classification(X, y, idx, res.W, **kw)
        port = T_tr.run_classification(X, y, idx, res.W, device="cpu", params0=params0,
                                       batch_indices=batch_idx, **kw)
    else:
        ref = J_tr.run_classification(X, y, idx, None,
                                      schedule=J_mix.schedule_from_result(res), **kw)
        port = T_tr.run_classification(X, y, idx, None, schedule=schedule_from_result(res),
                                       device="cpu", params0=params0,
                                       batch_indices=batch_idx, **kw)
    # float32 reductions (matmuls, log-softmax sums, means) run in another
    # order in torch than in XLA, and the differences grow over the steps;
    # 1e-4 relative on the losses leaves room for that and nothing more
    assert [r["step"] for r in port.history] == [r["step"] for r in ref.history]
    np.testing.assert_allclose(port.column("loss"), ref.column("loss"), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.column("consensus"), ref.column("consensus"),
                               rtol=1e-3, atol=1e-6)
    assert port.column("acc_mean").shape == (4,)  # t = 0, 5, 10 and the last step
    np.testing.assert_allclose(port.column("acc_mean"), ref.column("acc_mean"), atol=0.02)


def test_stacked_classifier_matches_reference_logits():
    rng = np.random.default_rng(0)
    params0 = {"w1": rng.normal(size=(6, 5)), "b1": rng.normal(size=5),
               "w2": rng.normal(size=(5, 3)), "b2": rng.normal(size=3)}
    params0 = {k: v.astype(np.float32) for k, v in params0.items()}
    net = T_tr.StackedClassifier(4, 6, 3, model="mlp", hidden=5, params0=params0,
                                 device="cpu")
    assert dict(net.named_parameters())["w1"].shape == (4, 6, 5)
    x = rng.normal(size=(4, 7, 6)).astype(np.float32)
    ref = np.stack([np.asarray(J_tr._classifier_logits(
        {k: jnp.asarray(v) for k, v in params0.items()}, jnp.asarray(xi))) for xi in x])
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The port's own random path: analogues of test_trainer_convergence.py
# ---------------------------------------------------------------------------

def test_mean_estimation_converges_on_complete_graph():
    task = mean_estimation_clusters(n_nodes=20, K=4, m=2.0)
    out = T_tr.run_mean_estimation(task, T.complete(20), steps=20, lr=0.2, seed=0,
                                   device="cpu")
    assert out["mean_sq_error"][-1] < 0.05


def test_stl_fw_beats_random_under_heterogeneity():
    task = mean_estimation_clusters(n_nodes=30, K=10, m=5.0)
    res = learn_topology(task.Pi, budget=9, lam=0.5)
    Wr = T.random_d_regular(30, 9, seed=0)
    out_stl = T_tr.run_mean_estimation(task, res.W, steps=20, lr=0.2, seed=0, device="cpu")
    out_rnd = T_tr.run_mean_estimation(task, Wr, steps=20, lr=0.2, seed=0, device="cpu")
    assert out_stl["mean_sq_error"][-1] < 0.5 * out_rnd["mean_sq_error"][-1]


def test_classification_accuracy_improves_on_own_draws():
    X, y, X_te, y_te, idx, Pi = _classification_data(n=20)
    res = learn_topology(Pi, budget=5, lam=0.1)
    log = T_tr.run_classification(X, y, idx, None, schedule=schedule_from_result(res),
                                  steps=20, batch_size=32, lr=0.5, eval_every=19,
                                  X_test=X_te, y_test=y_te, device="cpu")
    first, final = [r for r in log.history if "acc_mean" in r]
    assert final["acc_mean"] > 0.6 and final["acc_mean"] > first["acc_mean"]
    assert np.isfinite(final["consensus"])
    again = T_tr.run_classification(X, y, idx, None, schedule=schedule_from_result(res),
                                    steps=20, batch_size=32, lr=0.5, eval_every=19,
                                    X_test=X_te, y_test=y_te, device="cpu")
    assert np.array_equal(again.column("loss"), log.column("loss"))  # seeded


def test_kernel_numerics_equal_plain_training():
    task = mean_estimation_clusters(n_nodes=8, K=4, m=2.0)
    W = T.ring(8)
    a = T_tr.run_mean_estimation(task, W, steps=10, lr=0.2, use_kernel=False, device="cpu")
    b = T_tr.run_mean_estimation(task, W, steps=10, lr=0.2, use_kernel=True, device="cpu")
    np.testing.assert_allclose(a["theta"], b["theta"], atol=1e-5)


# ---------------------------------------------------------------------------
# Entry-point contract
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = mean_estimation_clusters(n_nodes=4, K=2, m=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_tr.run_mean_estimation(task, T.complete(4), steps=2)
    X, y, X_te, y_te, idx, _ = _classification_data(n=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_tr.run_classification(X, y, idx, T.complete(4), steps=2)


def test_later_slices_raise():
    task = mean_estimation_clusters(n_nodes=4, K=2, m=1.0)
    # a PoolSwap from the hook: the drivers take ScheduleArrays only, as the reference's
    sa = schedule_to_arrays(schedule_from_result(learn_topology(task.Pi, budget=2, lam=0.5)),
                            l_max=4, device="cpu")
    pool_swap = PoolSwap(gammas=np.full(4, 0.25, np.float32))
    for rollout in ("loop", "scan"):
        with pytest.raises(NotImplementedError, match="ScheduleArrays only"):
            T_tr.run_mean_estimation(task, None, schedule=sa, steps=4, segment_len=2,
                                     on_segment=lambda t: pool_swap, rollout=rollout,
                                     device="cpu")
    X, y, _, _, idx, _ = _classification_data(n=4)
    with pytest.raises(ValueError):
        T_tr.run_classification(X, y, idx, T.complete(4), steps=2, device="cpu",
                                batch_indices=np.zeros((3, 4, 32), np.int64))
