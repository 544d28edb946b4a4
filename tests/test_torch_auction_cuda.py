"""The device auction kernel and the device LMO's host side, on the card.

Tests marked ``cuda`` skip without a CUDA device. The kernel is held to
its plain version (``kernels/auction/ref.py``, run on the host on the
same values: its branches read every scalar back, which on the card
costs ~0.3 ms a bid) for an identical assignment, prices and counters,
and to scipy for the objective. The overlap drill runs on the CPU too,
where the plain version solves and the rollout runs eagerly. This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_auction_cuda.py
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from scipy.optimize import linear_sum_assignment  # noqa: E402

from repro_torch import graphs  # noqa: E402
from repro_torch.core.assignment_jit import AuctionWorkspace, auction_assignment_jit  # noqa: E402
from repro_torch.core.mixing import measure_transport  # noqa: E402
from repro_torch.core.stl_fw import LMOSolver, learn_topology, stl_fw_gradient  # noqa: E402
from repro_torch.data.synthetic import mean_estimation_clusters  # noqa: E402
from repro_torch.kernels.auction import ops  # noqa: E402
from repro_torch.kernels.auction.ref import auction_ref  # noqa: E402
from repro_torch.online import (  # noqa: E402
    OnlineTopologyController,
    RefreshConfig,
    TopologyRefresher,
)
from repro_torch.online.streaming import DriftDetector  # noqa: E402
from repro_torch.train.trainer import run_mean_estimation  # noqa: E402

VARIANTS = ("forward", "forward_reverse")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _obj(cost, col):
    return float(cost[np.arange(len(col)), col].sum())


def fw_gradient(n: int, K: int = 10, seed: int = 0, steps: int = 3) -> np.ndarray:
    """The STL-FW gradient of a Dirichlet(0.1) Pi a few FW steps in."""
    Pi = np.random.default_rng(seed).dirichlet(0.1 * np.ones(K), size=n)
    res = learn_topology(Pi, budget=steps, lam=0.1, lmo="scipy")
    return stl_fw_gradient(res.W, Pi, 0.1)


def _cost(n: int, seed: int) -> np.ndarray:
    if n >= 64:
        return fw_gradient(n, seed=seed)
    return np.random.default_rng(seed).normal(size=(n, n))


def _both(cost, device, warm=None, scale=1.0, variant="forward", gs=64):
    """The kernel on the card and the plain version on the host, same values."""
    n = cost.shape[0]
    kw = dict(warm_scale=scale, have_warm=warm is not None, rel_grid=1e-12, scaling=3000.0,
              forward_reverse=variant == "forward_reverse", validate=False,
              gs_threshold=gs, max_iters=500 * n + 200_000)
    if warm is None:
        warm = (torch.zeros(n, dtype=torch.float64), torch.full((n,), -1, dtype=torch.int32))
    c = torch.as_tensor(cost, dtype=torch.float64)
    ws = AuctionWorkspace(n, device)
    before = ops.launch_counts["auction"]
    k = ops.auction(c.to(device), warm[0].to(device), warm[1].to(device), **ws.buffers, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["auction"] == before + 1
    r = auction_ref(c, warm[0].cpu(), warm[1].cpu(), **kw)
    return [x.cpu() for x in k], r


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2, 3, 17, 64, 128, 512])
def test_kernel_is_its_plain_version_cold_and_warm(cuda, n, variant):
    cost = _cost(n, n)
    (kc, kp, ks), (rc, rp, rs) = _both(cost, cuda, variant=variant)
    assert torch.equal(kc, rc) and torch.equal(kp, rp) and torch.equal(ks, rs)
    cost2 = 0.8 * cost + 0.2 * _cost(n, n + 1)
    (wc, wp, ws), (rc2, rp2, rs2) = _both(cost2, cuda, warm=(kp, kc), scale=0.8, variant=variant)
    assert torch.equal(wc, rc2) and torch.equal(wp, rp2) and torch.equal(ws, rs2)
    ref = _obj(cost2, linear_sum_assignment(cost2)[1])
    assert abs(_obj(cost2, wc.numpy()) - ref) <= 1e-9 * max(1.0, abs(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [2, 16])
def test_kernel_is_its_plain_version_on_tied_integer_costs(cuda, gs):
    cost = np.random.default_rng(4).integers(0, 3, size=(48, 48)).astype(np.float64)
    (kc, kp, ks), (rc, rp, rs) = _both(cost, cuda, gs=gs)
    assert torch.equal(kc, rc) and torch.equal(kp, rp) and torch.equal(ks, rs)
    assert _obj(cost, kc.numpy()) == _obj(cost, linear_sum_assignment(cost)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2, 100, 1024, 2048, 4096])
def test_device_lmo_objective_is_scipys(cuda, n, variant):
    cost = _cost(n, 7)
    col, state = auction_assignment_jit(cost, validate=False, device=cuda, variant=variant)
    ref = _obj(cost, linear_sum_assignment(cost)[1])
    assert abs(_obj(cost, col) - ref) <= 1e-9 * max(1.0, abs(ref))
    assert state.prices.is_cuda and state.prices.dtype == torch.float64
    cost2 = 0.9 * cost + 0.1 * _cost(n, 8)
    col2, _ = auction_assignment_jit(cost2, state.scaled(0.9), validate=False, variant=variant)
    ref2 = _obj(cost2, linear_sum_assignment(cost2)[1])
    assert abs(_obj(cost2, col2) - ref2) <= 1e-9 * max(1.0, abs(ref2))


@pytest.mark.cuda
def test_host_contract_on_the_card(cuda):
    cost = np.array([[np.inf, 1.0, 4.0], [2.0, np.inf, 6.0], [3.0, 8.0, np.inf]])
    col, _ = auction_assignment_jit(cost, device=cuda)
    assert _obj(cost, col) == pytest.approx(10.0)
    bad = np.ones((3, 3))
    bad[0, 1] = np.nan
    with pytest.raises(ValueError, match="NaN or -inf"):
        auction_assignment_jit(bad, device=cuda)
    blocked = np.ones((3, 3))
    blocked[:, 1] = np.inf
    with pytest.raises(ValueError, match="fully forbidden"):
        auction_assignment_jit(blocked, device=cuda)
    col, state = auction_assignment_jit(np.full((5, 5), 2.0), device=cuda)
    assert sorted(col) == list(range(5)) and float(state.prices.abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_wrapper_needs_its_buffers_on_the_card(cuda):
    n = 8
    c = torch.as_tensor(_cost(n, 1), device=cuda)
    kw = dict(warm_scale=1.0, have_warm=False, rel_grid=1e-12, scaling=3000.0,
              forward_reverse=False, validate=False, gs_threshold=64, max_iters=10_000)
    warm = (torch.zeros(n, dtype=torch.float64, device=cuda),
            torch.full((n,), -1, dtype=torch.int32, device=cuda))
    before = ops.launch_counts["auction"]
    with pytest.raises(ValueError, match="benefit, out and work buffers"):
        ops.auction(c, *warm, **kw)
    assert ops.launch_counts["auction"] == before


@pytest.mark.cuda
def test_round_cap_raises(cuda):
    cost = _cost(64, 3)
    before = ops.launch_counts["auction"]
    with pytest.raises(RuntimeError, match="did not converge in 5 bidding rounds"):
        auction_assignment_jit(cost, max_iters=5, device=cuda)
    assert ops.launch_counts["auction"] == before + 1


@pytest.mark.cuda
def test_one_launch_a_solve_and_the_prices_stay_on_the_card(cuda):
    Pi = np.random.default_rng(5).dirichlet(0.1 * np.ones(8), size=64)
    solver = LMOSolver("auction_jit", device=cuda)
    before = ops.launch_counts["auction"]
    res = learn_topology(Pi, budget=8, lam=0.1, lmo=solver)
    ref = learn_topology(Pi, budget=8, lam=0.1, lmo="scipy")
    assert ops.launch_counts["auction"] - before == 9  # 8 FW steps and the final gap
    assert solver.state.prices is solver.workspace.prices and solver.state.prices.is_cuda
    np.testing.assert_allclose(res.objective_trace, ref.objective_trace, atol=1e-9)
    assert res.lmo_backend == "auction_jit"


@pytest.mark.cuda
def test_measure_transport_raises_inside_a_capture(cuda):
    measure_transport(16, 2, 4096, device=cuda)  # outside a capture it measures
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            measure_transport(16, 2, 4096, device=cuda)


def overlap_drill(device, overlap: bool, n: int, K: int, steps: int, seg: int):
    """One requested refresh with the device LMO in a captured mean
    estimation run. In overlap mode the solve is submitted at the first
    boundary and has started when the next segment -- the body's second
    run, its capture -- begins; the next boundary collects it (``flush``).
    Inline, the solve runs at the first boundary and its swap is handed
    back at the next one, so both runs swap at the same step."""
    rng = np.random.default_rng(0)
    task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=1.0)
    Pi0 = rng.dirichlet(0.3 * np.ones(K), size=n)
    Pi1 = Pi0[rng.permutation(n)]
    labels = np.stack([[rng.choice(K, size=4, p=Pi1[i]) for i in range(n)]
                       for _ in range(steps)])
    zs = np.asarray(task.cluster_means)[labels] + rng.normal(size=labels.shape)
    res0 = learn_topology(Pi0, budget=8, lam=0.5, lmo="scipy")
    ref = TopologyRefresher(res0, RefreshConfig(budget=8, lam=0.5), lmo="auction_jit",
                            device=device)
    ctl = OnlineTopologyController(ref, Pi0=Pi0, detector=DriftDetector(threshold=1e30),
                                   overlap=overlap)
    started = threading.Event()
    refresh = ref.refresh

    def timed_refresh(Pi_hat):
        started.set()
        return refresh(Pi_hat)

    ref.refresh = timed_refresh
    fed, held, in_flight = [0], [], []
    capture = graphs.GraphRunner._capture

    def watched_capture(self, body, what):
        pending = ctl._pending
        in_flight.append(pending is not None and not pending[0].done())
        return capture(self, body, what)

    def hook(t):
        while fed[0] <= t:
            ctl.observe(labels[fed[0]])
            fed[0] += 1
        if overlap:
            if ctl.refresh_pending:
                return ctl.flush(t)
            out = ctl.on_segment(t)
            if ctl.refresh_pending:
                assert started.wait(timeout=120)
            return out
        if held:
            return held.pop()
        out = ctl.on_segment(t)
        if out is not None:
            held.append(out)
        return None

    ctl.request_refresh("drill")
    graphs.GraphRunner._capture = watched_capture
    try:
        out = run_mean_estimation(task, None, steps=steps, lr=0.05, batch=4, schedule=ctl.schedule_arrays(),
                                  zs=zs, on_segment=hook, segment_len=seg, rollout="scan",
                                  device=device)
    finally:
        graphs.GraphRunner._capture = capture
        ctl.close()
    return out, ref, in_flight


def _check_overlap_against_inline(device, **sizes):
    over, ref_o, in_flight = overlap_drill(device, True, **sizes)
    inline, ref_i, _ = overlap_drill(device, False, **sizes)
    assert ref_o.n_refreshes == ref_i.n_refreshes == 1
    assert over["swaps"] == inline["swaps"] and len(over["swaps"]) == 1
    np.testing.assert_array_equal(over["mean_sq_error"], inline["mean_sq_error"])
    assert over["n_traces"] == inline["n_traces"] == 1
    return in_flight


def test_overlap_device_lmo_swaps_as_inline_on_the_cpu():
    _check_overlap_against_inline("cpu", n=16, K=4, steps=60, seg=10)


@pytest.mark.cuda
def test_overlap_device_lmo_captures_while_a_refresh_is_in_flight(cuda):
    in_flight = _check_overlap_against_inline(cuda, n=64, K=8, steps=120, seg=20)
    assert in_flight == [True]  # the one capture opened with the solve running
