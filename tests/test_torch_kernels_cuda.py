"""The hand-written CUDA gossip kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports no JAX, so it also runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.mixing import (  # noqa: E402
    mix_stacked,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.kernels.gossip_mix import ops, ref  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    ops.reset_launch_counts()
    return torch.device("cuda")


def _schedule(n: int):
    labels = np.random.default_rng(n).integers(0, 10, size=30 * n)
    Pi = dirichlet_partition(labels, n, alpha=0.3, seed=0)[1]
    return schedule_from_result(learn_topology(Pi, budget=min(4, n), lam=0.1))


def _theta(n, P, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, P), generator=gen).to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# gossip_mix's kernels: float32 n <= 128 the 3xTF32 one (n = 9, 128),
# n = 129 and 161 (float32) W resident in shared memory, n = 512 K-tiled;
# bfloat16 W-resident up to n = 192. n = 9, 129 and 161 are not
# multiples of 8; P = 4113, 1001, 4099, 515 and 2051 are odd and P = 50890
# is 2 mod 4: no 16-byte copies.
@pytest.mark.parametrize("n,P", [(2, 1), (33, 4113), (100, 50896), (7, 300), (9, 1001),
                                 (128, 333), (129, 515), (161, 4099), (512, 2051),
                                 (100, 50890)])
def test_kernels_match_plain_on_card(cuda, n, P, dtype):
    sched = _schedule(n)
    t = _theta(n, P, dtype, cuda)
    g, p = sched.operands(cuda)
    out = ops.gossip_schedule(t, g, p)
    # the same float32 arithmetic in the same order: bitwise equal
    torch.testing.assert_close(out, ref.gossip_schedule_ref(t, g, p), atol=0, rtol=0)
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32, device=cuda)
    mixed = ops.gossip_mix(t, W)
    tol = TOL[dtype]
    torch.testing.assert_close(mixed.float(), ref.gossip_mix_ref(t, W.to(dtype)).float(),
                               atol=tol, rtol=tol)
    assert ops.launch_counts == {"gossip_schedule": 1, "gossip_mix": 1}


def _atoms(n: int, L: int, zeros: int, seed: int, device):
    """The identity and L - 1 random permutations with positive weights,
    then ``zeros`` zero-weight padding atoms (as ``ScheduleArrays`` pads)."""
    rng = np.random.default_rng(seed)
    perms = [np.arange(n)] + [rng.permutation(n) for _ in range(L - 1 + zeros)]
    g = rng.random(L) + 0.1
    g = np.concatenate([g / g.sum(), np.zeros(zeros)])
    return (torch.as_tensor(g, dtype=torch.float32, device=device),
            torch.as_tensor(np.stack(perms), dtype=torch.int32, device=device))


# The staged kernel (float32; bfloat16 runs the l2 gather) keeps a column
# tile of all n rows in shared memory; on an H100 (227 KB a block) n = 100
# takes 512-byte rows, n = 500 with
# L = 3 128-byte rows, n = 1000 two 64-byte stages, n = 1500 one, and with
# L = 2 n = 2075 is the last n that holds one (its perms table, 8 atoms a
# row, takes the rest): n = 2076 runs the l2 gather.
# P = 4099 and 777 are odd; offset 1 puts every row off the 16-byte grid.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,P,L,zeros,offset,design", [
    (100, 50896, 11, 0, 0, "staged tile, 512-byte rows x 4 stages"),
    (100, 50890, 11, 3, 0, "staged tile"),
    (100, 4096, 11, 0, 1, "staged tile"),
    (7, 4099, 3, 2, 1, "staged tile, 512-byte rows x 8 stages"),
    (500, 3001, 3, 0, 1, "staged tile, 128-byte rows x 3 stages"),
    (1000, 520, 3, 0, 0, "staged tile, 64-byte rows x 2 stages"),
    (1500, 777, 3, 0, 1, "staged tile, 64-byte rows x 1 stages"),
    (2075, 300, 2, 0, 0, "staged tile, 64-byte rows x 1 stages"),
    (2076, 300, 2, 0, 0, "l2 gather"),
    (4096, 1001, 3, 1, 1, "l2 gather"),
])
def test_gossip_schedule_designs_match_plain_on_card(cuda, n, P, L, zeros, offset, design, dtype):
    g, p = _atoms(n, L, zeros, n + P, cuda)
    buf = _theta(1, n * P + offset, dtype, cuda, 4)[0]
    t = buf[offset:].view(n, P)
    assert t.is_contiguous() and (t.data_ptr() % 16 != 0) == (offset != 0)
    want = design if dtype == torch.float32 else "l2 gather"
    assert ops.gossip_schedule_design(n, L + zeros, dtype).startswith(want)
    out = ops.gossip_schedule(t, g, p)
    # the same float32 arithmetic in the same order: bitwise equal
    torch.testing.assert_close(out, ref.gossip_schedule_ref(t, g, p), atol=0, rtol=0)
    assert ops.launch_counts == {"gossip_schedule": 1, "gossip_mix": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,P", [(100, 4096), (9, 1000), (512, 1028)])
def test_gossip_mix_on_misaligned_theta(cuda, n, P, dtype):
    """A contiguous theta at offset 1 of a larger buffer: its rows start
    4 (float32) or 2 (bfloat16) bytes off the 16-byte grid."""
    W = torch.as_tensor(_schedule(n).to_matrix(), dtype=torch.float32, device=cuda)
    buf = _theta(1, n * P + 1, dtype, cuda, 3)[0]
    t = buf[1:].view(n, P)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    mixed = ops.gossip_mix(t, W)
    tol = TOL[dtype]
    torch.testing.assert_close(mixed.float(), ref.gossip_mix_ref(t, W.to(dtype)).float(),
                               atol=tol, rtol=tol)
    assert ops.launch_counts["gossip_mix"] == 1


@pytest.mark.cuda
def test_mixing_on_card_goes_through_the_kernels(cuda):
    n = 33
    sched = _schedule(n)
    tree = {"w": _theta(n, 120, torch.float32, cuda, 1).reshape(n, 12, 10),
            "b": _theta(n, 10, torch.float32, cuda, 2)}
    W = torch.as_tensor(sched.to_matrix(), dtype=torch.float32, device=cuda)
    for use_kernel in (False, True):
        dense = mix_stacked(tree, W=W, transport="dense", use_kernel=use_kernel)
        sparse = mix_stacked(tree, schedule=sched, transport="schedule", use_kernel=use_kernel)
        arrays = mix_stacked(tree, schedule=schedule_to_arrays(sched, l_max=sched.n_atoms + 2,
                                                                device=cuda))
        for k in tree:
            torch.testing.assert_close(dense[k], sparse[k], atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(arrays[k], sparse[k], atol=0, rtol=0)
    # per use_kernel: one gossip_mix per leaf, one gossip_schedule per schedule mix
    assert ops.launch_counts == {"gossip_schedule": 4, "gossip_mix": 4}


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    t = _theta(4, 16, torch.float32, cuda)
    with pytest.raises(ValueError):
        ops.gossip_schedule(t, torch.ones(1), torch.arange(4, dtype=torch.int32)[None].to(cuda))


# ---------------------------------------------------------------------------
# Capture: the kernels inside CUDA graphs, and the captured rollout
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,P", [(100, 50896), (33, 4113)])
def test_kernels_capture_and_take_new_operands_by_copy(cuda, n, P, dtype):
    theta = _theta(n, P, dtype, cuda, 3)
    g, p = _atoms(n, 5, 2, seed=4, device=cuda)
    W = torch.as_tensor(_schedule(n).to_matrix(), dtype=torch.float32, device=cuda)
    ops.gossip_schedule(theta, g, p)  # warm-up: build, load, one-time attribute calls
    ops.gossip_mix(theta, W)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s = ops.gossip_schedule(theta, g, p)
        out_m = ops.gossip_mix(theta, W)
    tol = TOL[dtype]
    for seed in (5, 6):
        if seed == 6:  # new operands, copied into the captured ones
            g2, p2 = _atoms(n, 7, 0, seed=seed, device=cuda)
            g.copy_(g2)
            p.copy_(p2)
            theta.copy_(_theta(n, P, dtype, cuda, seed))
            W.copy_(torch.eye(n, device=cuda).roll(1, 0) * 0.5 + W * 0.5)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out_s, ref.gossip_schedule_ref(theta, g, p), atol=0, rtol=0)
        torch.testing.assert_close(out_m.float(), ref.gossip_mix_ref(theta, W.to(dtype)).float(),
                                   atol=tol, rtol=tol)


def _mlp_data(n=16):
    from repro_torch.data.partition import shard_partition
    from repro_torch.data.synthetic import gaussian_blobs

    X, y = gaussian_blobs(800, 10, dim=32, sep=2.5, seed=0)
    idx, Pi = shard_partition(y[:700], n, shards_per_node=2, seed=0)
    return X[:700], y[:700], X[700:], y[700:], idx, Pi


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["schedule", "dense", "arrays"])
def test_captured_classification_equals_the_loop_on_card(cuda, arm):
    from repro_torch.train.trainer import run_classification

    X, y, X_te, y_te, idx, Pi = _mlp_data()
    res = learn_topology(Pi, budget=4, lam=0.1)
    sched = schedule_from_result(res)
    W, kw = None, {}
    if arm == "schedule":
        kw["schedule"] = sched
    elif arm == "dense":
        W = res.W
    else:
        other = schedule_to_arrays(schedule_from_result(learn_topology(Pi[::-1].copy(), budget=4,
                                                                       lam=0.1)),
                                   l_max=8, device=cuda)
        kw.update(schedule=schedule_to_arrays(sched, l_max=8, device=cuda),
                  on_segment=lambda t: other if t == 10 else None)
    logs, counts = {}, {}
    for rollout in ("loop", "scan"):
        ops.reset_launch_counts()
        logs[rollout] = run_classification(
            X, y, idx, W, model="mlp", hidden=16, steps=41, batch_size=16, lr=0.2,
            eval_every=5, X_test=X_te, y_test=y_te, seed=0, rollout=rollout, device=cuda, **kw)
        counts[rollout] = dict(ops.launch_counts)
    # the same kernels on the same inputs, and the same random draws
    assert logs["scan"].history == logs["loop"].history
    assert logs["scan"].aux["swaps"] == logs["loop"].aux["swaps"]
    assert logs["scan"].aux["n_traces"] == 1  # the 5-step body (1 + 8 x 5 steps)
    want = {"gossip_schedule": 0 if arm == "dense" else 41, "gossip_mix": 4 * 41 if arm == "dense" else 0}
    assert counts["scan"] == counts["loop"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["W", "arrays-swap"])
def test_captured_mean_estimation_equals_the_loop_on_card(cuda, form):
    from repro_torch.data.synthetic import mean_estimation_clusters
    from repro_torch.obs import RetraceGuard
    from repro_torch.train.trainer import run_mean_estimation

    task = mean_estimation_clusters(24, K=4, m=3.0)
    res = learn_topology(task.Pi, budget=4, lam=0.5)
    if form == "W":  # one 150-step segment: bodies of 64, 64 and 22 steps
        kw, steps = {"W": res.W}, 150
    else:
        sa2 = schedule_to_arrays(schedule_from_result(learn_topology(task.Pi[::-1].copy(),
                                                                     budget=4, lam=0.5)),
                                 l_max=9, device=cuda)
        kw = {"W": None, "schedule": schedule_to_arrays(schedule_from_result(res), l_max=9,
                                                        device=cuda),
              "segment_len": 10, "on_segment": lambda t: sa2 if t == 29 else None}
        steps = 100
    outs, counts = {}, {}
    for rollout in ("loop", "scan"):
        guard = RetraceGuard()
        ops.reset_launch_counts()
        outs[rollout] = run_mean_estimation(task, steps=steps, lr=0.2, seed=1, rollout=rollout,
                                            retrace_guard=guard, device=cuda, **kw)
        counts[rollout] = dict(ops.launch_counts)
        if form != "W":
            assert outs[rollout]["n_traces"] == 1 and guard.counts == {"mean_estimation.roll": 1}
    for key in ("mean_sq_error", "max_sq_error", "min_sq_error", "theta"):
        assert np.array_equal(outs["scan"][key], outs["loop"][key]), key
    want = {"gossip_schedule": 0, "gossip_mix": steps} if form == "W" else \
        {"gossip_schedule": steps, "gossip_mix": 0}
    assert counts["scan"] == counts["loop"] == want  # replays count their launches


@pytest.mark.cuda
def test_a_failed_capture_raises_and_never_runs_eagerly(cuda):
    from repro_torch.train.rollout import SegmentRunner

    x = torch.ones(4, device=cuda)

    def body():
        x.add_(float(x.sum()))  # a host read: illegal inside a capture

    runner = SegmentRunner("test.roll", cuda, captured=True)
    segment = dict(t0=0, length=3, schedule=None, make_body=lambda k, sched: (body, None, x),
                   fill=lambda inputs, t, k: None)
    runner.run_segment(**segment)  # the body's first run: the eager warm-up
    with pytest.raises(RuntimeError, match="does not fall back"):
        runner.run_segment(**segment)  # its second: the capture, which fails
    torch.cuda.synchronize()
    assert float(x[0]) == 5.0  # the warm-up's one run, nothing more
    assert runner.n_traces == 1


# ---------------------------------------------------------------------------
# The robustness layer inside the captured rollout
# ---------------------------------------------------------------------------

def _arrays_pair(Pi, device, l_max=8):
    a = schedule_to_arrays(schedule_from_result(learn_topology(Pi, budget=4, lam=0.1)),
                           l_max=l_max, device=device)
    b = schedule_to_arrays(schedule_from_result(learn_topology(Pi[::-1].copy(), budget=4,
                                                               lam=0.1)),
                           l_max=l_max, device=device)
    return a, b


class _LiveEstimate:
    """A hook with a live ``estimator.Pi_hat`` that moves at every call,
    handing back a new schedule at one step."""

    def __init__(self, Pi, swap_at, new):
        self.estimator = type("Estimator", (), {})()
        self.estimator.Pi_hat = Pi
        self.swap_at, self.new = swap_at, new

    def __call__(self, t):
        self.estimator.Pi_hat = np.roll(self.estimator.Pi_hat, 1, axis=0)
        return self.new if t == self.swap_at else None


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16", "topk", "wait", "probes"])
def test_robust_classification_graph_equals_the_loop_on_card(cuda, arm):
    """bf16 and top-k EF, ``wait`` staleness under a changing delay stream,
    and probes with a live pi_hat: each with a swap, graph bitwise the
    loop, one capture, and every mix in gossip_schedule."""
    from repro_torch.core.mixing import StragglerPolicy
    from repro_torch.obs import HealthProbes
    from repro_torch.train.trainer import run_classification

    X, y, X_te, y_te, idx, Pi = _mlp_data()
    n, steps = len(idx), 41
    sa, sa2 = _arrays_pair(Pi, cuda)
    kw = {"bf16": dict(compression="bf16"),
          "topk": dict(compression="topk:0.1:g0.25"),
          "wait": dict(staleness=StragglerPolicy("wait", 3),
                       delays=np.random.default_rng(0).integers(0, 5, (steps, n))),
          "probes": dict(probes=HealthProbes(tau_bar=True), pi_hat=Pi)}[arm]
    logs, counts = {}, {}
    for rollout in ("loop", "scan"):
        ops.reset_launch_counts()
        logs[rollout] = run_classification(
            X, y, idx, None, schedule=sa, on_segment=_LiveEstimate(Pi, 10, sa2), model="mlp",
            hidden=16, steps=steps, batch_size=16, lr=0.2, eval_every=5, X_test=X_te,
            y_test=y_te, seed=0, rollout=rollout, device=cuda, **kw)
        counts[rollout] = dict(ops.launch_counts)
    assert logs["scan"].history == logs["loop"].history
    assert logs["scan"].aux["swaps"] == logs["loop"].aux["swaps"] == [10]
    assert logs["scan"].aux["n_traces"] == 1
    for name, series in logs["scan"].aux.get("health", {}).items():
        assert np.array_equal(series, logs["loop"].aux["health"][name]), name
    # the tau_bar probe mixes pi_hat through the kernel too
    want = 2 * steps if arm == "probes" else steps
    assert counts["scan"] == counts["loop"] == {"gossip_schedule": want, "gossip_mix": 0}


@pytest.mark.cuda
def test_robust_arms_equal_the_fresh_run_bitwise_on_card(cuda):
    """Identity compression, zero delays and probes change nothing of the
    run on the card, as on the CPU."""
    from repro_torch.core.mixing import StragglerPolicy
    from repro_torch.obs import HealthProbes
    from repro_torch.train.trainer import run_classification

    X, y, X_te, y_te, idx, Pi = _mlp_data()
    sa, sa2 = _arrays_pair(Pi, cuda)
    kw = dict(schedule=sa, model="mlp", hidden=16, steps=31, batch_size=16, lr=0.2,
              eval_every=5, X_test=X_te, y_test=y_te, seed=0, device=cuda)
    base = run_classification(X, y, idx, None, on_segment=lambda t: sa2 if t == 10 else None,
                              **kw)
    for extra in (dict(compression="identity"), dict(staleness=StragglerPolicy("wait", 4)),
                  dict(staleness=StragglerPolicy("degrade", 4)),
                  dict(probes=HealthProbes())):
        log = run_classification(X, y, idx, None, on_segment=lambda t: sa2 if t == 10 else None,
                                 **extra, **kw)
        assert log.history == base.history, extra
        assert log.aux["comm"]["total_bytes"] == base.aux["comm"]["total_bytes"], extra


@pytest.mark.cuda
def test_screened_and_corrupted_mixes_on_card(cuda):
    """The stacked-source mixes run in gossip_schedule: with nothing
    corrupt they are the clean mix bitwise, and with liars they match the
    plain version on the CPU."""
    from repro_torch.core import mixing as M

    n, P = 32, 1000
    g, p = (t.to(cuda) for t in _schedule(n).operands("cpu"))
    sa = M.ScheduleArrays(g, p)
    theta = _theta(n, P, torch.float32, cuda)
    buf = M.stale_buffer_init(theta, 3)
    own = _theta(n, P, torch.float32, cuda, seed=1)
    M.stale_push(buf, own)
    zero = torch.zeros(n, dtype=torch.int32, device=cuda)
    clean = M.mix_schedule_arrays_stale(buf, sa, zero)
    honest = M.WireCorruption(torch.ones(n, device=cuda), torch.zeros(n, dtype=torch.int32,
                                                                        device=cuda))
    screened, _ = M.mix_schedule_arrays_screened(buf, sa, zero, own, honest)
    assert torch.equal(clean, ops.gossip_schedule(own, g, p))
    assert torch.equal(screened, clean)
    assert torch.equal(M.mix_schedule_arrays_stale(buf, sa, zero, honest), clean)
    mult = torch.ones(n, device=cuda)
    mult[3], mult[7] = float("nan"), -1.0
    liars = M.WireCorruption(mult, torch.zeros(n, dtype=torch.int32, device=cuda))
    delays = torch.randint(0, 3, (n,), generator=torch.Generator().manual_seed(0)).to(cuda)
    on_card = M.mix_schedule_arrays_screened(buf, sa, delays, own, liars)
    cpu_buf = M.StaleBuffer(buf.buf.cpu(), buf.head.cpu())
    cpu_liars = M.WireCorruption(liars.mult.cpu(), liars.xor.cpu())
    on_cpu = M.mix_schedule_arrays_screened(cpu_buf, M.ScheduleArrays(g.cpu(), p.cpu()),
                                            delays.cpu(), own.cpu(), cpu_liars)
    assert torch.equal(on_card[0].cpu(), on_cpu[0])  # the kernel's sums are the plain ones
    assert torch.equal(on_card[1].finite.cpu(), on_cpu[1].finite)


@pytest.mark.cuda
def test_fault_runner_captures_once_and_resumes_bitwise_on_card(cuda, tmp_path):
    """A crash, stragglers, drops and a NaN liar that the quarantine
    catches (a repaired schedule stream mid-run): one capture, graph
    bitwise the loop, and a resume from a checkpoint bitwise the
    uninterrupted run."""
    from repro_torch.data.synthetic import mean_estimation_clusters
    from repro_torch.faults import FaultPlan, QuarantineController, ScreenPolicy, \
        run_faulty_mean_estimation

    n, steps = 16, 120
    task = mean_estimation_clusters(n_nodes=n, K=4, m=5.0, sigma_tilde2=1.0)
    res = learn_topology(task.Pi, budget=8, lam=0.1)
    sched = schedule_from_result(res)
    sa = schedule_to_arrays(sched, sched.n_atoms + 2, device=cuda)
    faults = dict(n_nodes=n, steps=steps, seed=3, crash_rate=0.02, mean_outage=6.0,
                  straggler_rate=0.3, tau_max=2, edge_drop_rate=0.05)
    plan = FaultPlan(**faults)
    plan.corrupt_mult[5:, 0] = np.nan
    kw = dict(lr=0.05, seed=2, segment_len=20, device=cuda)

    def controller():
        return QuarantineController(n, ScreenPolicy(cooldown_steps=2 * steps), lr=0.05)

    outs, qs = {}, {}
    for rollout in ("loop", "scan"):
        qs[rollout] = controller()
        outs[rollout] = run_faulty_mean_estimation(task, plan, sa, quarantine=qs[rollout],
                                                   rollout=rollout, **kw)
    assert outs["scan"]["n_traces"] == 1
    assert np.array_equal(outs["scan"]["mean_sq_error"], outs["loop"]["mean_sq_error"])
    assert qs["scan"].events == qs["loop"].events and qs["scan"].n_quarantines >= 1
    plan = FaultPlan(**faults)  # the crash drill: no liar
    full = run_faulty_mean_estimation(task, plan, sa, **kw)
    head = run_faulty_mean_estimation(task, plan, sa, checkpoint_dir=str(tmp_path),
                                      stop_after_segments=3, **kw)
    tail = run_faulty_mean_estimation(task, plan, sa, checkpoint_dir=str(tmp_path), resume=True,
                                      **kw)
    assert full["n_traces"] == 1 and np.isfinite(full["mean_sq_error"]).all()
    assert head["stopped_at"] == tail["resumed_from"] == 60
    assert np.array_equal(np.concatenate([head["mean_sq_error"], tail["mean_sq_error"]]),
                          full["mean_sq_error"])
    assert np.array_equal(tail["theta"], full["theta"])
