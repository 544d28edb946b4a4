"""Health probes (``repro_torch.obs.probes``) against ``repro.obs.probes``.

Each probe is held to the reference's on the same numpy-seeded inputs at
1e-6 relative (float32 sums in another order). Through the drivers a
probes-on run must be bitwise the probes-off run -- the probe values are
extra outputs of the bodies and change nothing they carry -- with a
schedule swap, in both rollouts, with the capture count unchanged; the
health series are held to the reference drivers' at 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.mixing as J_mix  # noqa: E402
import repro.obs.probes as J_probes  # noqa: E402
from repro.data.synthetic import mean_estimation_clusters as j_mec  # noqa: E402
from repro.train import trainer as J_tr  # noqa: E402

import repro_torch.obs as T_obs  # noqa: E402
import repro_torch.obs.probes as T_probes  # noqa: E402
from repro_torch.core.mixing import (  # noqa: E402
    ScheduleArrays,
    StragglerPolicy,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import cluster_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.train import trainer as T_tr  # noqa: E402

RTOL = 1e-6


def _atoms(n, L, seed):
    rng = np.random.default_rng(seed)
    g = rng.dirichlet(np.ones(L)).astype(np.float32)
    p = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)]).astype(np.int32)
    return g, p


def _both_arrays(g, p):
    return (ScheduleArrays(torch.from_numpy(g), torch.from_numpy(p)),
            J_mix.ScheduleArrays(jnp.asarray(g), jnp.asarray(p)))


@pytest.mark.parametrize("n,L,K", [(6, 3, 4), (16, 5, 10)])
def test_probes_match_reference(n, L, K):
    g, p = _atoms(n, L, n)
    t_sa, j_sa = _both_arrays(g, p)
    rng = np.random.default_rng(n + L)
    pi = rng.dirichlet(np.ones(K), size=n).astype(np.float32)
    tree = {"a": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32)}
    t_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
    pairs = [
        (T_probes.consensus_sq(t_tree), J_probes.consensus_sq(j_tree)),
        (T_probes.grad_deviation_sq(t_tree), J_probes.grad_deviation_sq(j_tree)),
        (T_probes.mix_pi_arrays(t_sa, torch.from_numpy(pi)),
         J_probes.mix_pi_arrays(j_sa, jnp.asarray(pi))),
        (T_probes.w_frobenius_sq(t_sa), J_probes.w_frobenius_sq(j_sa)),
        (T_probes.w_minus_j_frobenius_sq(t_sa), J_probes.w_minus_j_frobenius_sq(j_sa)),
        (T_probes.tau_bar_arrays(t_sa, torch.from_numpy(pi), 2.0, 0.5),
         J_probes.tau_bar_arrays(j_sa, jnp.asarray(pi), 2.0, 0.5)),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-7)
    cfg = dict(consensus=True, grad_dev=True, tau_bar=True, B=2.0, sigma2=0.5)
    port = T_probes.compute_probes(T_probes.HealthProbes(**cfg), params_stack=t_tree,
                                   grads_stack=t_tree, arrays=t_sa, pi_hat=torch.from_numpy(pi))
    ref = J_probes.compute_probes(J_probes.HealthProbes(**cfg), params_stack=j_tree,
                                  grads_stack=j_tree, arrays=j_sa, pi_hat=jnp.asarray(pi))
    assert list(port) == list(ref) == ["consensus", "grad_dev", "tau_bar"]
    for name in port:
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]), rtol=RTOL)


def test_health_probes_config_and_exports():
    assert T_probes.HealthProbes().names() == J_probes.HealthProbes().names()
    assert T_probes.HealthProbes(tau_bar=True, consensus=False).names() == ("grad_dev", "tau_bar")
    with pytest.raises(ValueError, match="every probe disabled"):
        T_probes.HealthProbes(consensus=False, grad_dev=False)
    with pytest.raises(ValueError, match="B must be"):
        T_probes.HealthProbes(tau_bar=True, B=-1.0)
    with pytest.raises(ValueError, match="tau_bar probe needs"):
        T_probes.compute_probes(T_probes.HealthProbes(tau_bar=True, consensus=False,
                                                      grad_dev=False))
    for name in J_probes.__all__:
        assert getattr(T_obs, name) is getattr(T_probes, name)


def _arrays(Pi, budget, l_max, lam=0.5):
    return schedule_to_arrays(schedule_from_result(learn_topology(Pi, budget=budget, lam=lam)),
                              l_max=l_max, device="cpu")


def _j_arrays(sa):
    return J_mix.ScheduleArrays(jnp.asarray(sa.gammas.numpy()), jnp.asarray(sa.perms.numpy()))


class _Estimator:
    """A hook with a live ``estimator.Pi_hat`` that moves at each call."""

    def __init__(self, Pi, swap_at, new):
        self.estimator = type("E", (), {})()
        self.estimator.Pi_hat = Pi
        self.swap_at, self.new, self.calls = swap_at, new, 0

    def __call__(self, t):
        self.calls += 1
        self.estimator.Pi_hat = np.roll(self.estimator.Pi_hat, 1, axis=0)
        return self.new if t == self.swap_at else None


def test_probes_on_is_bitwise_probes_off_in_mean_estimation():
    n, K, steps, seg = 12, 4, 30, 5
    task = mean_estimation_clusters(n_nodes=n, K=K, m=3.0)
    Pi = np.eye(K)[np.arange(n) % K]
    sa, sa2 = _arrays(Pi, 4, 8), _arrays(Pi[::-1].copy(), 4, 8)
    probes = T_probes.HealthProbes(tau_bar=True, B=1.0, sigma2=0.1)
    kw = dict(steps=steps, lr=0.2, seed=1, segment_len=seg, device="cpu")
    outs = {}
    for rollout in ("scan", "loop"):
        for on in (True, False):
            extra = dict(probes=probes, pi_hat=Pi) if on else {}
            outs[rollout, on] = T_tr.run_mean_estimation(
                task, None, schedule=sa, rollout=rollout,
                on_segment=_Estimator(Pi, 14, sa2), **extra, **kw)
    base = outs["scan", False]
    for key, out in outs.items():
        for field in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
            assert np.array_equal(out[field], base[field]), (key, field)
        assert out["swaps"] == [14] and out["n_traces"] == 1, key
    assert np.array_equal(outs["scan", True]["health"]["tau_bar"],
                          outs["loop", True]["health"]["tau_bar"])
    # the reference's driver on the same data, the same swap and the same
    # live estimate
    jtask = j_mec(n_nodes=n, K=K, m=3.0)
    ref = J_tr.run_mean_estimation(
        jtask, None, schedule=_j_arrays(sa), on_segment=_Estimator(Pi, 14, _j_arrays(sa2)),
        probes=J_probes.HealthProbes(tau_bar=True, B=1.0, sigma2=0.1), pi_hat=Pi,
        steps=steps, lr=0.2, seed=1, segment_len=seg)
    port = outs["scan", True]
    assert list(port["health"]) == list(ref["health"])
    for name, series in ref["health"].items():
        np.testing.assert_allclose(port["health"][name], series, rtol=1e-5, atol=1e-7)


def test_probes_on_is_bitwise_probes_off_in_classification():
    X, y = gaussian_blobs(n_samples=300, num_classes=4, dim=8, seed=0)
    n = 8
    idx, Pi = cluster_partition(y, n)
    sa, sa2 = _arrays(Pi, 3, 6), _arrays(Pi[::-1].copy(), 3, 6)
    kw = dict(model="mlp", hidden=8, steps=23, batch_size=8, lr=0.3, eval_every=5,
              X_test=X[:50], y_test=y[:50], seed=3, device="cpu")
    logs = {}
    for rollout in ("scan", "loop"):
        for on in (True, False):
            extra = (dict(probes=T_probes.HealthProbes(tau_bar=True), pi_hat=Pi) if on else {})
            logs[rollout, on] = T_tr.run_classification(
                X, y, idx, None, schedule=sa, rollout=rollout,
                on_segment=_Estimator(Pi, 10, sa2), **extra, **kw)
    base = logs["scan", False]
    for key, log in logs.items():
        assert log.history == base.history, key
        assert log.aux["swaps"] == [10] and log.aux["n_traces"] == 1, key
    health = logs["scan", True].aux["health"]
    assert set(health) == {"consensus", "grad_dev", "tau_bar"}
    assert all(v.shape == (23,) and np.isfinite(v).all() for v in health.values())
    for name, v in health.items():
        assert np.array_equal(v, logs["loop", True].aux["health"][name]), name


def test_probe_arguments_are_checked_as_the_reference_checks_them():
    n = 4
    task = mean_estimation_clusters(n_nodes=n, K=2, m=1.0)
    sa = _arrays(np.eye(2)[np.arange(n) % 2], 2, 4)
    probes = T_probes.HealthProbes(tau_bar=True)
    cases = [
        (dict(schedule=sa, pi_hat=np.ones((n, 2))), ValueError, "pi_hat without probes"),
        (dict(schedule=sa, probes="consensus"), TypeError, "HealthProbes"),
        (dict(probes=T_probes.HealthProbes()), ValueError, "data plane"),
        (dict(schedule=sa, probes=probes), ValueError, "needs pi_hat"),
        (dict(schedule=sa, probes=probes, pi_hat=np.ones((n + 1, 2))), ValueError,
         "pi_hat must be"),
        (dict(schedule=sa, probes=T_probes.HealthProbes(), pi_hat=np.ones((n, 2))), ValueError,
         "tau_bar is off"),
        (dict(schedule=sa, probes=T_probes.HealthProbes(),
              staleness=StragglerPolicy("wait", 1)), ValueError, "bounded-delay"),
    ]
    for kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            T_tr.run_mean_estimation(task, None, steps=4, device="cpu", **kw)
