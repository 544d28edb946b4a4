"""The port's numpy host math against the reference's, on the same inputs.

The port keeps copies of the reference's numpy modules (data, topology,
heterogeneity, assignment, STL-FW, D-Cliques), so parity is equality:
the same arrays, bit for bit, and the same learned W, coefficients and
permutation atoms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import assignment as J_asg  # noqa: E402
from repro.core import dcliques as J_dc  # noqa: E402
from repro.core import heterogeneity as J_het  # noqa: E402
from repro.core import stl_fw as J_fw  # noqa: E402
from repro.core import topology as J_top  # noqa: E402
from repro.data import partition as J_part  # noqa: E402
from repro.data import synthetic as J_syn  # noqa: E402
from repro_torch.core import assignment as T_asg  # noqa: E402
from repro_torch.core import dcliques as T_dc  # noqa: E402
from repro_torch.core import heterogeneity as T_het  # noqa: E402
from repro_torch.core import stl_fw as T_fw  # noqa: E402
from repro_torch.core import topology as T_top  # noqa: E402
from repro_torch.data import partition as T_part  # noqa: E402
from repro_torch.data import synthetic as T_syn  # noqa: E402


def _labels(n_samples: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 10, size=n_samples)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dim", [2, 48])
def test_gaussian_blobs_equal(seed, dim):
    Xj, yj = J_syn.gaussian_blobs(500, 10, dim=dim, sep=2.5, seed=seed)
    Xt, yt = T_syn.gaussian_blobs(500, 10, dim=dim, sep=2.5, seed=seed)
    assert np.array_equal(Xj, Xt) and np.array_equal(yj, yt)
    assert Xt.dtype == np.float32 and yt.dtype == np.int32


@pytest.mark.parametrize("n,K,m", [(20, 4, 2.0), (33, 10, 5.0)])
def test_mean_estimation_task_equal(n, K, m):
    a, b = J_syn.mean_estimation_clusters(n, K, m), T_syn.mean_estimation_clusters(n, K, m)
    assert np.array_equal(a.Pi, b.Pi) and a.theta_star == b.theta_star
    assert np.array_equal(a.sample(3, np.random.default_rng(1)),
                          b.sample(3, np.random.default_rng(1)))
    assert a.B == b.B and a.zeta_bar2 == b.zeta_bar2


@pytest.mark.parametrize("name", ["shard", "dirichlet", "cluster"])
def test_partitions_equal(name):
    y = _labels(2000, 0)
    if name == "shard":
        ja, tb = J_part.shard_partition(y, 25, seed=1), T_part.shard_partition(y, 25, seed=1)
    elif name == "dirichlet":
        ja = J_part.dirichlet_partition(y, 25, alpha=0.3, seed=1)
        tb = T_part.dirichlet_partition(y, 25, alpha=0.3, seed=1)
    else:
        ja, tb = J_part.cluster_partition(y, 25, seed=1), T_part.cluster_partition(y, 25, seed=1)
    assert len(ja[0]) == len(tb[0])
    assert all(np.array_equal(a, b) for a, b in zip(ja[0], tb[0]))
    assert np.array_equal(ja[1], tb[1])


@pytest.mark.parametrize(
    "builder,args",
    [
        ("complete", (9,)),
        ("ring", (9,)),
        ("alternating_ring", (10,)),
        ("star", (9,)),
        ("torus", (3, 4)),
        ("random_d_regular", (20, 3)),
        ("exponential_graph", (16,)),
    ],
)
def test_topology_builders_equal(builder, args):
    Wj = getattr(J_top, builder)(*args)
    Wt = getattr(T_top, builder)(*args)
    assert np.array_equal(Wj, Wt)
    assert T_top.is_doubly_stochastic(Wt)
    assert T_top.mixing_parameter(Wt) == J_top.mixing_parameter(Wj)


def test_d_cliques_equal():
    y = _labels(3000, 2)
    _, Pi = T_part.shard_partition(y, 30, seed=0)
    assert np.array_equal(J_dc.d_cliques(Pi, clique_size=10, seed=0),
                          T_dc.d_cliques(Pi, clique_size=10, seed=0))


def _pi(kind: str, n: int) -> np.ndarray:
    if kind == "one-hot":
        return T_syn.mean_estimation_clusters(n, K=5, m=1.0).Pi
    return T_part.dirichlet_partition(_labels(40 * n, 4), n, alpha=0.3, seed=0)[1]


@pytest.mark.parametrize("lmo", ["scipy", "auction"])
@pytest.mark.parametrize("kind,n,budget", [("one-hot", 20, 6), ("dirichlet", 33, 8)])
def test_learn_topology_equal(lmo, kind, n, budget):
    Pi = _pi(kind, n)
    rj = J_fw.learn_topology(Pi, budget=budget, lam=0.1, lmo=lmo)
    rt = T_fw.learn_topology(Pi, budget=budget, lam=0.1, lmo=lmo)
    assert rt.lmo_backend == rj.lmo_backend == lmo
    assert np.array_equal(rj.W, rt.W)
    assert np.array_equal(rj.coeffs, rt.coeffs)
    assert len(rj.perms) == len(rt.perms)
    assert all(np.array_equal(a, b) for a, b in zip(rj.perms, rt.perms))
    assert np.array_equal(rj.objective_trace, rt.objective_trace)
    assert np.array_equal(rj.gap_trace, rt.gap_trace)


def test_learn_topology_reference_method_equal():
    Pi = _pi("dirichlet", 16)
    rj = J_fw.learn_topology(Pi, budget=5, method="reference")
    rt = T_fw.learn_topology(Pi, budget=5, method="reference")
    assert np.array_equal(rj.W, rt.W) and np.array_equal(rj.coeffs, rt.coeffs)


def test_lmo_resolution_without_the_jitted_auction():
    assert T_fw.resolve_lmo_backend("auto", n=1024, budget=64) == "scipy"
    assert T_fw.resolve_lmo_backend("auction_jit") == "auction"
    res = T_fw.learn_topology(_pi("one-hot", 12), budget=3, lmo="auction_jit")
    assert res.lmo_backend == "auction"
    P, col = T_asg.solve_lmo(np.random.default_rng(0).normal(size=(8, 8)), backend="auction_jit")
    assert np.array_equal(P[np.arange(8), col], np.ones(8))
    with pytest.raises(ValueError):
        T_fw.resolve_lmo_backend("bogus")


@pytest.mark.parametrize("solver", ["hungarian", "linear_assignment", "auction"])
def test_assignment_solvers_equal(solver):
    cost = np.random.default_rng(5).normal(size=(17, 17))
    if solver == "auction":
        cj, _ = J_asg.auction_assignment(cost)
        ct, _ = T_asg.auction_assignment(cost)
    else:
        cj, ct = getattr(J_asg, solver)(cost), getattr(T_asg, solver)(cost)
    assert np.array_equal(cj, ct)


@pytest.mark.parametrize("kind,n", [("one-hot", 20), ("dirichlet", 33)])
def test_heterogeneity_equal(kind, n):
    Pi = _pi(kind, n)
    W = T_fw.learn_topology(Pi, budget=4, lam=0.1).W
    assert abs(J_het.label_skew_bias(W, Pi) - T_het.label_skew_bias(W, Pi)) <= 1e-12
    kw = dict(sigma_max2=1.0, B=2.0)
    assert abs(J_het.tau_bar_label_skew(W, Pi, **kw) - T_het.tau_bar_label_skew(W, Pi, **kw)) <= 1e-12
    assert np.allclose(J_het.prop3_bounds(W), T_het.prop3_bounds(W), rtol=0, atol=1e-12)
