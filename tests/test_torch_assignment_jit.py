"""The port's device auction LMO on the CPU (its plain version) against the
reference's numpy solvers and scipy.

The cases of ``tests/test_assignment_jit.py``, whose module no longer
imports under the installed jax (``jax.experimental.enable_x64``), are
re-stated against ``repro_torch.core.assignment_jit`` with
``device="cpu"``. The oracles are the reference's own
``auction_assignment``, ``linear_assignment`` and ``hungarian``, and
``learn_topology(lmo="scipy" | "auction")``; the tolerance is the
reference test's: the objective within ``1e-9 * max(1, |obj|)``.
Assignments may differ under exact ties, so solvers are compared by
objective, and FW trajectories by their objective and step-size traces.
The plain version's kernel-level contract (its stats, ``ops.auction``'s
checks) is tested here too; the kernel itself runs in
``tests/test_torch_auction_cuda.py``.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.assignment import (  # noqa: E402
    auction_assignment,
    hungarian,
    linear_assignment,
    solve_lmo as J_solve_lmo,
)
from repro.core import stl_fw as J_fw  # noqa: E402
from repro_torch.core import assignment as T_asg  # noqa: E402
from repro_torch.core import stl_fw as T_fw  # noqa: E402
from repro_torch.core.assignment_jit import (  # noqa: E402
    AuctionJitState,
    auction_assignment_jit,
)
from repro_torch.kernels.auction import ops as auction_ops  # noqa: E402
from repro_torch.kernels.auction.ref import STATS, tree_sum  # noqa: E402

CPU = "cpu"
VARIANTS = ("forward", "forward_reverse")


def _jit(cost, warm=None, **kw):
    return auction_assignment_jit(cost, warm, device=CPU, **kw)


def _obj(cost, col):
    return float(cost[np.arange(len(col)), col].sum())


def _assert_perm(col, n):
    assert sorted(int(c) for c in col) == list(range(n))


# ---------------------------------------------------------------------------
# degenerate shapes and values
# ---------------------------------------------------------------------------

def test_n0_and_n1():
    col, state = _jit(np.empty((0, 0)))
    assert col.shape == (0,) and state.prices.shape == (0,)
    col, state = _jit(np.array([[3.7]]))
    assert list(col) == [0]
    assert isinstance(state.prices, torch.Tensor) and state.prices.dtype == torch.float64


@pytest.mark.parametrize("variant", VARIANTS)
def test_all_equal_costs(variant):
    """Fully tied problem: any permutation is optimal; must terminate."""
    for n in (2, 6):
        cost = np.full((n, n), 2.5)
        col, state = _jit(cost, variant=variant)
        _assert_perm(col, n)
        assert _obj(cost, col) == pytest.approx(2.5 * n)
        assert float(state.prices.abs().max()) == 0.0 and state.n_rounds == 0


def test_nonsquare_raises():
    with pytest.raises(ValueError):
        _jit(np.zeros((3, 4)))
    with pytest.raises(ValueError):
        _jit(np.zeros(3))


def test_bad_args_raise():
    with pytest.raises(ValueError):
        _jit(np.eye(3), variant="sideways")
    with pytest.raises(ValueError):
        _jit(np.eye(3), scaling=0.5)


def test_forbidden_entries_feasible():
    cost = np.array([
        [np.inf, 1.0, 4.0],
        [2.0, np.inf, 6.0],
        [3.0, 8.0, np.inf],
    ])
    col, _ = _jit(cost)
    _assert_perm(col, 3)
    assert _obj(cost, col) == pytest.approx(1.0 + 3.0 + 6.0)


def test_forbidden_entries_infeasible():
    cost = np.array([
        [1.0, np.inf, np.inf],
        [1.0, np.inf, np.inf],
        [1.0, 1.0, 1.0],
    ])
    with pytest.raises(ValueError):
        _jit(cost)


@pytest.mark.parametrize("axis", [0, 1])
def test_fully_forbidden_row_or_column_raises(axis):
    cost = np.ones((3, 3))
    if axis == 0:
        cost[1] = np.inf
    else:
        cost[:, 2] = np.inf
    with pytest.raises(ValueError, match="fully forbidden"):
        _jit(cost)


@pytest.mark.parametrize("bad", [np.nan, -np.inf])
def test_nan_and_neginf_rejected(bad):
    cost = np.ones((3, 3))
    cost[1, 2] = bad
    with pytest.raises(ValueError, match="NaN or -inf"):
        _jit(cost)
    with pytest.raises(ValueError):
        _jit(np.array([[bad]]))


def test_forbidden_entries_do_not_coarsen_quantization():
    """The +inf sentinel is ~(n+1)x the finite costs; the grid must come
    from the finite entries only."""
    rng = np.random.default_rng(11)
    n = 16
    cost = rng.normal(size=(n, n))
    forbidden = rng.random((n, n)) < 0.05
    forbidden[np.arange(n), linear_assignment(cost)] = False  # stay feasible
    cost[forbidden] = np.inf
    col, _ = _jit(cost)
    ref = linear_assignment(cost)
    assert abs(_obj(cost, col) - _obj(cost, ref)) < 1e-9


# ---------------------------------------------------------------------------
# solver agreement
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.sampled_from([2, 3, 6, 16]), st.integers(0, 100_000))
def test_agrees_with_references_on_generic(n, seed):
    # gs_threshold=2 makes the bucketed Jacobi rounds (and the reverse
    # rounds of forward_reverse) carry the bidding
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(n, n)) * 10.0 ** rng.integers(-6, 6)
    ref = _obj(cost, linear_assignment(cost))
    scale = max(1.0, abs(ref))
    for variant in VARIANTS:
        for gs_threshold in (2, None):
            col, _ = _jit(cost, variant=variant, gs_threshold=gs_threshold)
            _assert_perm(col, n)
            assert abs(_obj(cost, col) - ref) <= 1e-9 * scale, (variant, gs_threshold)
    assert abs(_obj(cost, hungarian(cost)) - ref) <= 1e-9 * scale
    assert abs(_obj(cost, auction_assignment(cost)[0]) - ref) <= 1e-9 * scale


@settings(max_examples=6, deadline=None)
@given(st.sampled_from([3, 6, 16]), st.integers(0, 10_000))
def test_agrees_on_tied_integer_costs(n, seed):
    """Small-integer costs: many exact ties, and the stagnation rescue."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 3, size=(n, n)).astype(np.float64)
    ref = _obj(cost, linear_assignment(cost))
    for variant in VARIANTS:
        for gs_threshold in (2, None):
            col, _ = _jit(cost, variant=variant, gs_threshold=gs_threshold)
            assert _obj(cost, col) == pytest.approx(ref, abs=1e-9), (variant, gs_threshold)


def test_near_duplicate_row_label_skew_instances():
    """Gram matrices of label-skew Pi with near-duplicate rows: long
    eviction chains; gs_threshold=4 keeps the Jacobi and reverse rounds in play."""
    rng = np.random.default_rng(5)
    n, K = 16, 8
    Pi = rng.dirichlet(np.ones(K) * 0.1, size=n)
    Pi[n // 2:] = np.maximum(Pi[: n // 2] + rng.normal(size=(n // 2, K)) * 1e-9, 1e-12)
    G = -(Pi @ Pi.T)
    ref = _obj(G, linear_assignment(G))
    for variant in VARIANTS:
        col, state = _jit(G, variant=variant, gs_threshold=4)
        _assert_perm(col, n)
        assert abs(_obj(G, col) - ref) <= 1e-9 * max(1.0, abs(ref)), variant
        assert state.n_rounds > 0


def test_validate_false_fast_path_matches():
    rng = np.random.default_rng(9)
    cost = rng.normal(size=(16, 16))
    col_v, _ = _jit(cost, validate=True)
    col_f, _ = _jit(cost, validate=False)
    assert _obj(cost, col_v) == pytest.approx(_obj(cost, col_f), abs=1e-12)


def test_round_cap_raises():
    cost = np.random.default_rng(2).normal(size=(8, 8))
    with pytest.raises(RuntimeError, match="did not converge"):
        _jit(cost, max_iters=3)


# ---------------------------------------------------------------------------
# warm start: state threading, deferred contraction, fast path
# ---------------------------------------------------------------------------

def test_warm_start_exact_after_perturbation():
    rng = np.random.default_rng(3)
    n = 16
    cost = rng.normal(size=(n, n))
    col, state = _jit(cost)
    for it in range(5):
        gamma = 1.0 / (it + 2)
        cost = (1.0 - gamma) * cost + gamma * rng.normal(size=(n, n))
        col, state = _jit(cost, state.scaled(1.0 - gamma))
        _assert_perm(col, n)
        ref = linear_assignment(cost)
        assert _obj(cost, col) == pytest.approx(_obj(cost, ref), abs=1e-9)


def test_warm_fast_path_identical_cost():
    """Carried duals that still certify optimality: zero bidding."""
    rng = np.random.default_rng(3)
    cost = rng.normal(size=(16, 16))
    col, state = _jit(cost)
    col2, state2 = _jit(cost, state)
    assert np.array_equal(col, col2)
    assert state2.n_rounds == 0 and state2.n_rebid_rows == 0


def test_warm_resolve_cheap_on_identical_cost():
    rng = np.random.default_rng(4)
    n = 16
    cost = rng.normal(size=(n, n))
    col, state = _jit(cost)
    col2, state2 = _jit(cost, state)
    assert _obj(cost, col2) == pytest.approx(_obj(cost, col), abs=1e-12)
    assert state2.n_rounds < n * 4


def test_scaled_defers_contraction():
    st_ = AuctionJitState(prices=np.array([1.0, -2.0]), col_of_row=np.array([1, 0]))
    out = st_.scaled(0.5).scaled(0.5)
    np.testing.assert_allclose(np.asarray(out.prices), [1.0, -2.0])  # untouched
    assert out.pending_scale == pytest.approx(0.25)
    assert np.array_equal(out.col_of_row, st_.col_of_row)


def test_scaled_warm_start_equals_contracted_prices():
    """The deferred contraction is applied inside the solve: a state scaled
    by f gives the same solve as one whose prices were multiplied by f."""
    rng = np.random.default_rng(8)
    cost = rng.normal(size=(12, 12))
    _, state = _jit(cost)
    cost2 = 0.7 * cost + 0.3 * rng.normal(size=(12, 12))
    a_col, a = _jit(cost2, state.scaled(0.7))
    b_col, b = _jit(cost2, AuctionJitState(prices=state.prices * 0.7,
                                           col_of_row=state.col_of_row))
    assert np.array_equal(a_col, b_col) and torch.equal(a.prices, b.prices)
    assert (a.n_rounds, a.n_rebid_rows) == (b.n_rounds, b.n_rebid_rows)


def test_ignores_malformed_warm_state():
    rng = np.random.default_rng(5)
    cost = rng.normal(size=(10, 10))
    ref = linear_assignment(cost)
    bad_states = [
        AuctionJitState(prices=np.zeros(4), col_of_row=np.zeros(4, np.int64)),
        AuctionJitState(prices=np.zeros(10),
                        col_of_row=np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 15])),
        AuctionJitState(prices=np.full(10, np.inf), col_of_row=np.arange(10)),
        # prices of a wildly differently-scaled problem: a cold solve
        AuctionJitState(prices=rng.normal(size=10) * 1e6, col_of_row=np.arange(10)),
        # non-finite pending contraction
        AuctionJitState(prices=np.zeros(10), col_of_row=np.arange(10), pending_scale=np.nan),
    ]
    for bad in bad_states:
        col, state = _jit(cost, bad)
        assert _obj(cost, col) == pytest.approx(_obj(cost, ref), abs=1e-12)
        assert state.n_rebid_rows == 10  # a cold solve reports every row


# ---------------------------------------------------------------------------
# the plain version's own contract (what the kernel is held to on the card)
# ---------------------------------------------------------------------------

def test_tree_sum_is_the_fixed_pairwise_order():
    x = torch.tensor([1e16, 1.0, -1e16, 1.0, 3.0], dtype=torch.float64)
    # ((1e16 + -1e16) + (1 + 1)) + 3, pairing i with i + 4, then i + 2, i + 1
    assert tree_sum(x) == ((1e16 + 3.0) + -1e16) + (1.0 + 1.0)
    assert tree_sum(torch.tensor([2.5], dtype=torch.float64)) == 2.5


def test_ops_auction_checks_its_inputs():
    n = 4
    cost = torch.zeros((n, n), dtype=torch.float64)
    kw = dict(warm_scale=1.0, have_warm=False, rel_grid=1e-12, scaling=3000.0,
              forward_reverse=False, validate=True, gs_threshold=n, max_iters=1000)
    wp, wc = torch.zeros(n, dtype=torch.float64), torch.full((n,), -1, dtype=torch.int32)
    col, prices, stats = auction_ops.auction(cost, wp, wc, **kw)
    assert col.dtype == torch.int32 and prices.dtype == torch.float64
    assert stats.shape == (len(STATS),) and dict(zip(STATS, stats.tolist()))["tied"] == 1
    with pytest.raises(ValueError):
        auction_ops.auction(cost.float(), wp, wc, **kw)
    with pytest.raises(ValueError):
        auction_ops.auction(cost, wp, wc.long(), **kw)
    with pytest.raises(ValueError):
        auction_ops.auction(cost[:1, :1].contiguous(), wp[:1], wc[:1], **kw)
    assert auction_ops.launch_counts["auction"] == 0  # the CPU launches nothing


# ---------------------------------------------------------------------------
# learn_topology integration: trajectories and backend resolution
# ---------------------------------------------------------------------------

def test_solve_lmo_auction_jit_backend():
    rng = np.random.default_rng(6)
    grad = rng.normal(size=(12, 12))
    ref_P, _ = J_solve_lmo(grad)
    P, col = T_asg.solve_lmo(grad, backend="auction_jit", device=CPU)
    assert float((P * grad).sum()) == pytest.approx(float((ref_P * grad).sum()), abs=1e-12)


@pytest.mark.parametrize("method", ["incremental", "reference"])
def test_learn_topology_jit_matches_reference_scipy_traces(method):
    rng = np.random.default_rng(7)
    Pi = rng.dirichlet(np.ones(6) * 0.3, size=24)
    ref = J_fw.learn_topology(Pi, budget=12, lam=0.2, method=method, lmo="scipy")
    jit = T_fw.learn_topology(Pi, budget=12, lam=0.2, method=method,
                              lmo=T_fw.LMOSolver("auction_jit", device=CPU))
    np.testing.assert_allclose(jit.objective_trace, ref.objective_trace, atol=1e-9)
    np.testing.assert_allclose(jit.gamma_trace, ref.gamma_trace, atol=1e-9)
    np.testing.assert_allclose(jit.gap_trace, ref.gap_trace, atol=1e-9)
    assert jit.lmo_backend == "auction_jit"


def test_learn_topology_warm_trajectory_matches_reference_numpy_auction():
    rng = np.random.default_rng(17)
    Pi = rng.dirichlet(np.ones(5) * 0.2, size=20)
    a = J_fw.learn_topology(Pi, budget=16, lam=0.1, lmo="auction")
    b = T_fw.learn_topology(Pi, budget=16, lam=0.1, lmo="auction_jit", device=CPU)
    np.testing.assert_allclose(b.objective_trace, a.objective_trace, atol=1e-9)
    np.testing.assert_allclose(b.gamma_trace, a.gamma_trace, atol=1e-9)
    # the warm state threads: the solver ends with a live state
    solver = T_fw.LMOSolver("auction_jit", device=CPU)
    res = T_fw.learn_topology(Pi, budget=6, lam=0.1, lmo=solver)
    assert solver.state is not None and solver.state.col_of_row.shape == (20,)
    assert res.lmo_backend == "auction_jit"


def test_learn_topology_one_hot():
    """One-hot Pi (exactly tied LMO optima): bias eliminated by l = K - 1,
    the objective monotone, as the reference's backends do."""
    K, n = 5, 20
    Pi = np.zeros((n, K))
    Pi[np.arange(n), np.arange(n) % K] = 1.0
    res = T_fw.learn_topology(Pi, budget=K - 1, lam=0.5, lmo="auction_jit", device=CPU)
    ref = J_fw.learn_topology(Pi, budget=K - 1, lam=0.5, lmo="scipy")
    assert res.bias_trace[-1] < 1e-12
    assert np.all(np.diff(res.objective_trace) <= 1e-12)
    np.testing.assert_allclose(res.objective_trace, ref.objective_trace, atol=1e-9)


_RESOLVE_ARGS = [("auto",), ("auto", 2048, 64), ("auto", 512, 24), ("auto", 100, 10),
                 ("auto", None, None), ("auto", 512, None), ("scipy",), ("hungarian",),
                 ("auction",), ("auction_jit",), ("auction_jit", 16, 4)]


@pytest.mark.parametrize("args", _RESOLVE_ARGS)
def test_resolve_lmo_backend_as_the_reference(args):
    assert T_fw.resolve_lmo_backend(*args) == J_fw.resolve_lmo_backend(*args)


@pytest.mark.parametrize("nb", [(None, None), (100, None), (512, None), (128, 128), (256, 64),
                                (512, 24), (512, 16), (1024, 8), (1024, 4)])
def test_jit_amortizes_as_the_reference(nb):
    assert T_fw._jit_amortizes(*nb) == J_fw._jit_amortizes(*nb)


def test_auto_without_scipy_picks_auction_jit_only_with_cuda(monkeypatch):
    monkeypatch.setattr(T_asg, "_scipy_lsa", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T_fw.resolve_lmo_backend("auto", n=2048, budget=64) == "auction"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert T_fw.resolve_lmo_backend("auto", n=2048, budget=64) == "auction_jit"
    assert T_fw.resolve_lmo_backend("auto", n=64, budget=8) == "auction"
    assert T_fw.resolve_lmo_backend("scipy") == "hungarian"


def test_auction_jit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        auction_assignment_jit(np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_fw.learn_topology(np.eye(4)[np.arange(8) % 4], budget=2, lmo="auction_jit")
