#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels`` and
then, on the card:

0. prints the card (``nvidia-smi``), the torch and CUDA versions and the
   kernels' build time;
1. holds each kernel against its plain PyTorch version on the same
   inputs, at the main path's shapes (float32 at atol = rtol = 1e-5,
   bfloat16 at 3e-2, the reference's tolerances), and times the kernel,
   the plain version and one library call computing the same function
   (median of 30 launches, CUDA events);
2. drives the main path through the user's entry points -- Pi from a
   label-skew partition, ``learn_topology``, ``schedule_from_result``,
   ``run_classification`` / ``run_mean_estimation`` on ``cuda`` -- and
   checks accuracies, losses, errors and the kernels' launch counts;
3. prints one JSON line per kernel set, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.

Any failed check raises, so the script exits non-zero and prints no
result; so it does without CUDA or outside a checkout of the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.mixing import (  # noqa: E402
    ScheduleArrays,
    arrays_to_matrix,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import learn_topology  # noqa: E402
from repro_torch.data.partition import dirichlet_partition, shard_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gossip_mix import ops  # noqa: E402
from repro_torch.kernels.gossip_mix.ref import gossip_mix_ref, gossip_schedule_ref  # noqa: E402
from repro_torch.train.trainer import run_classification, run_mean_estimation  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
TIMED_LAUNCHES = 30
WARMUP_LAUNCHES = 5

KERNELS = {
    "gossip_schedule": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_schedule.cu",
        "replaces": "src/repro/kernels/gossip_mix/gossip_schedule.py:58",
    },
    "gossip_mix": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix/gossip_mix.py:37",
    },
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_ms(fn, launches: int = TIMED_LAUNCHES, warmup: int = WARMUP_LAUNCHES) -> float:
    """Median device time of ``fn()`` in ms, one CUDA event pair per launch.

    A ~0.5 ms device sleep is queued before each timed launch, so the
    host has enqueued the launch before the device reaches it and the
    event pair brackets device work, not host overhead.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Data and topologies of the main path
# ---------------------------------------------------------------------------

def mnist_width_data(n_nodes: int = 100, n_samples: int = 70000, n_train: int = 60000,
                     dim: int = 784):
    """Phase 2b's data: an MNIST-shaped blob set, shard-partitioned."""
    X, y = gaussian_blobs(n_samples, 10, dim=dim, sep=2.5, seed=0)
    idx, Pi = shard_partition(y[:n_train], n_nodes, shards_per_node=2, seed=0)
    return X, y, idx, Pi


def dirichlet_pi(n_nodes: int = 512, samples_per_node: int = 100, alpha: float = 0.3):
    labels = np.random.default_rng(0).integers(0, 10, size=n_nodes * samples_per_node)
    return dirichlet_partition(labels, n_nodes, alpha=alpha, seed=0)[1]


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def schedule_bound(n: int, P: int, L: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of ``out = sum_l g_l theta[perm_l]`` in ms, and what bounds it."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * n * P * s + L * n * 4 + L * 4) / HBM_BYTES_PER_S
    t_ops = 2 * L * n * P / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mix_bound(n: int, P: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of ``out = W @ theta`` in ms, and what bounds it."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * n * P + n * n) * s / HBM_BYTES_PER_S
    t_ops = 2 * n * n * P / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _theta(n: int, P: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, P), generator=gen, device="cuda").to(dtype)


def _compare(name: str, out: torch.Tensor, plain: torch.Tensor, dtype) -> float:
    torch.cuda.synchronize()
    check(out.shape == plain.shape and out.dtype == plain.dtype, f"{name}: shape/dtype")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    tol = TOL[dtype]
    check(torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol),
          f"{name}: max |kernel - plain| = {err:.3e} exceeds atol = rtol = {tol}")
    return err


def schedule_case(label: str, theta: torch.Tensor, gammas: torch.Tensor,
                  perms: torch.Tensor) -> dict:
    n, P = theta.shape
    L = perms.shape[0]
    dtype = theta.dtype
    out = ops.gossip_schedule(theta, gammas, perms)
    plain = gossip_schedule_ref(theta, gammas, perms)
    err = _compare(f"gossip_schedule {label}", out, plain, dtype)
    W = torch.as_tensor(arrays_to_matrix(ScheduleArrays(gammas, perms)), dtype=dtype,
                        device="cuda")  # the densified W, for the library call
    bound, bound_by = schedule_bound(n, P, L, dtype)
    row = {
        "kernel": "gossip_schedule", "case": label, "n": n, "P": P, "L": L,
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "kernel_ms": device_ms(lambda: ops.gossip_schedule(theta, gammas, perms)),
        "plain_ms": device_ms(lambda: gossip_schedule_ref(theta, gammas, perms)),
        "library_ms": device_ms(lambda: torch.matmul(W, theta)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["GB_per_s"] = (2 * n * P * theta.element_size() + L * n * 4) / row["kernel_ms"] / 1e6
    return row


def mix_case(label: str, theta: torch.Tensor, W: torch.Tensor) -> dict:
    n, P = theta.shape
    dtype = theta.dtype
    Wc = W.to(dtype)  # the wrapper's cast, given to the plain version too
    out = ops.gossip_mix(theta, W)
    plain = gossip_mix_ref(theta, Wc)
    err = _compare(f"gossip_mix {label}", out, plain, dtype)
    bound, bound_by = mix_bound(n, P, dtype)
    row = {
        "kernel": "gossip_mix", "case": label, "n": n, "P": P,
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "kernel_ms": device_ms(lambda: ops.gossip_mix(theta, W)),
        "plain_ms": device_ms(lambda: gossip_mix_ref(theta, Wc)),
        "library_ms": device_ms(lambda: torch.matmul(Wc, theta)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["TFLOP_per_s"] = 2 * n * n * P / row["kernel_ms"] / 1e9
    return row


def phase_kernels(Pi_mnist: np.ndarray) -> list[dict]:
    """Every kernel case; the first row of each kernel is its headline."""
    res100 = learn_topology(Pi_mnist, budget=10, lam=0.1)
    s100 = schedule_from_result(res100)
    g100, p100 = s100.operands("cuda")
    res512 = learn_topology(dirichlet_pi(512), budget=8, lam=0.1)
    s512 = schedule_from_result(res512)
    padded = schedule_to_arrays(s100, l_max=s100.n_atoms + 5, device="cuda")
    W100 = torch.as_tensor(res100.W, dtype=torch.float32, device="cuda")
    W512 = torch.as_tensor(res512.W, dtype=torch.float32, device="cuda")
    P_mlp = 784 * 64 + 64 + 64 * 10 + 10  # 50890 parameters per node
    P_main = -(-P_mlp // 8) * 8  # the raveled width the main path passes (rows padded to 8)
    rows = [
        schedule_case("phase-2b main path", _theta(100, P_main, torch.float32, 1), g100, p100),
        schedule_case("P=50890 ragged", _theta(100, P_mlp, torch.float32, 2), g100, p100),
        schedule_case("P=50890 ragged", _theta(100, P_mlp, torch.bfloat16, 3), g100, p100),
        schedule_case("phase-2b main path", _theta(100, P_main, torch.bfloat16, 4), g100, p100),
        schedule_case("n=512 dirichlet", _theta(512, 2**20 + 37, torch.float32, 5),
                      *s512.operands("cuda")),
        schedule_case("zero-weight padding", _theta(100, P_main, torch.float32, 6),
                      padded.gammas, padded.perms),
        mix_case("P=50890", _theta(100, P_mlp, torch.float32, 7), W100),
        mix_case("P=50890", _theta(100, P_mlp, torch.bfloat16, 8), W100),
        mix_case("n=512", _theta(512, 2**18 + 37, torch.float32, 9), W512),
    ]
    for leaf, size in (("w1", 784 * 64), ("b1", 64), ("w2", 640), ("b2", 10)):
        rows.append(mix_case(f"phase-2b leaf {leaf}", _theta(100, size, torch.float32, 10), W100))
    return rows


# ---------------------------------------------------------------------------
# Phase 2: the main path through the user's entry points
# ---------------------------------------------------------------------------

def counted(fn, *args, **kwargs):
    """``fn(...)`` with the launch counts set to 0 just before it; returns
    (result, counts, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, dict(ops.launch_counts), time.perf_counter() - t0


def _final(log) -> dict:
    return [r for r in log.history if "acc_mean" in r][-1]


def fig2_protocol(device="cuda", n=100, n_samples=12000, n_train=10000, steps=150) -> dict:
    """Phase 2a: the paper's Fig. 2 protocol, stl-fw(d2) against random(d2)."""
    X, y = gaussian_blobs(n_samples, 10, dim=48, sep=2.5, seed=0)
    idx, Pi = shard_partition(y[:n_train], n, shards_per_node=2, seed=0)
    kw = dict(model="linear", steps=steps, batch_size=64, lr=0.3, eval_every=steps - 1,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device=device)
    sched = schedule_from_result(learn_topology(Pi, budget=2, lam=0.1))
    stl, stl_counts, stl_s = counted(
        run_classification, X[:n_train], y[:n_train], idx, None, schedule=sched, **kw)
    rnd, rnd_counts, rnd_s = counted(
        run_classification, X[:n_train], y[:n_train], idx, T.random_d_regular(n, 2, seed=0), **kw)
    return {"stl": _final(stl), "random": _final(rnd), "stl_counts": stl_counts,
            "random_counts": rnd_counts, "stl_s": stl_s, "random_s": rnd_s}


def mnist_width(data, device="cuda", steps=200) -> dict:
    """Phase 2b: MLP (P = 50890 per node) at n = 100, schedule and dense W."""
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2,
              eval_every=steps - 1, X_test=X[n_train:], y_test=y[n_train:], seed=0,
              device=device)
    out = {}
    for arm, W, sched in (("schedule", None, schedule_from_result(res)), ("dense", res.W, None)):
        log, counts, secs = counted(
            run_classification, X[:n_train], y[:n_train], idx, W, schedule=sched, **kw)
        out[arm] = {"final": _final(log), "loss": log.column("loss"), "counts": counts,
                    "seconds": secs, "steps_per_s": steps / secs}
    return out


def mean_estimation(device="cuda", n=100, steps=100) -> dict:
    """Phase 2c: Example 1 mean estimation on the STL-FW W and a random W."""
    task = mean_estimation_clusters(n)
    res = learn_topology(task.Pi, budget=9, lam=0.5)
    stl, stl_counts, _ = counted(run_mean_estimation, task, res.W, steps=steps, lr=0.1,
                                 device=device)
    rnd, rnd_counts, _ = counted(run_mean_estimation, task, T.random_d_regular(n, 9, seed=0),
                                 steps=steps, lr=0.1, device=device)
    return {"stl": stl["mean_sq_error"], "random": rnd["mean_sq_error"],
            "stl_counts": stl_counts, "random_counts": rnd_counts}


def fig2_reference_acc() -> float:
    """stl-fw(d2)'s acc_mean in the reference's experiments/bench/fig2.csv."""
    for line in (ROOT / "experiments" / "bench" / "fig2.csv").read_text().splitlines()[1:]:
        name, acc = line.split(",")[:2]
        if name == "stl-fw(d2)":
            return float(acc)
    raise RuntimeError("fig2.csv has no stl-fw(d2) row")


def phase_main_path(mnist) -> dict:
    launches = {"gossip_schedule": 0, "gossip_mix": 0}

    def expect(label, counts, schedule, mix):
        check(counts == {"gossip_schedule": schedule, "gossip_mix": mix},
              f"{label}: launches {counts}, expected schedule={schedule} mix={mix}")
        for k in launches:
            launches[k] += counts[k]
        print(f"# 2 {label}: launches {counts}")

    a = fig2_protocol()
    expect("2a stl-fw(d2) schedule, 150 steps", a["stl_counts"], 150, 0)
    expect("2a random(d2) dense, 150 steps x 2 leaves", a["random_counts"], 0, 300)
    ref_acc = fig2_reference_acc()
    print(f"# 2a acc_mean stl-fw(d2)={a['stl']['acc_mean']:.4f} "
          f"random(d2)={a['random']['acc_mean']:.4f} reference stl-fw(d2)={ref_acc:.4f} "
          f"({a['stl_s']:.2f} s, {a['random_s']:.2f} s)")
    check(a["stl"]["acc_mean"] >= a["random"]["acc_mean"] + 0.03,
          "2a: stl-fw(d2) does not beat random(d2) by 0.03")
    check(abs(a["stl"]["acc_mean"] - ref_acc) <= 0.03,
          f"2a: stl-fw(d2) acc_mean is not within 0.03 of the reference's {ref_acc:.4f}")

    b = mnist_width(mnist)
    expect("2b schedule, 200 steps", b["schedule"]["counts"], 200, 0)
    expect("2b dense W, 200 steps x 4 leaves", b["dense"]["counts"], 0, 800)
    for arm, r in b.items():
        loss = r["loss"]
        print(f"# 2b {arm}: acc_mean={r['final']['acc_mean']:.4f} "
              f"loss {loss[:10].mean():.4f} -> {loss[-10:].mean():.4f} "
              f"consensus={r['final']['consensus']:.4g} {r['steps_per_s']:.1f} steps/s "
              f"({r['seconds']:.2f} s with setup and 2 evals)")
        check(bool(np.isfinite(loss).all()), f"2b {arm}: non-finite loss")
        check(loss[-10:].mean() < loss[:10].mean(), f"2b {arm}: loss did not fall")
        check(r["final"]["acc_mean"] > 0.5, f"2b {arm}: acc_mean <= 0.5")

    c = mean_estimation()
    expect("2c mean estimation stl-fw W, 100 steps", c["stl_counts"], 0, 100)
    expect("2c mean estimation random(d9), 100 steps", c["random_counts"], 0, 100)
    print(f"# 2c mean_sq_error stl-fw {c['stl'][0]:.5f} -> {c['stl'][-1]:.5f}, "
          f"random(d9) final {c['random'][-1]:.5f}")
    check(bool(np.isfinite(c["stl"]).all()), "2c: non-finite error")
    check(c["stl"][-1] < c["stl"][0], "2c: final mean_sq_error is not below the first")
    check(c["stl"][-1] < 0.5 * c["random"][-1], "2c: stl-fw is not 2x below random(d9)")
    return launches


def step_breakdown(data, short: int = 20, long: int = 120) -> dict:
    """Phase 2e: where a phase-2b step's time goes.

    Steady-state ms per step of both arms, as the wall-time difference of
    a ``long`` and a ``short`` run without evaluation (setup cancels
    out), and, from ``torch.profiler`` over one ``short`` schedule-arm
    run, the device time per step by kernel. Host-to-device copies (the
    node data, copied once at setup) are left out of the per-step sums.
    """
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    arms = {"schedule": (None, schedule_from_result(res)), "dense": (res.W, None)}
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda")
    out = {}
    for arm, (W, sched) in arms.items():
        secs = {}
        for steps in (short, long):
            secs[steps] = counted(run_classification, X[:n_train], y[:n_train], idx, W,
                                  schedule=sched, steps=steps, **kw)[2]
        out[arm] = {"ms_per_step": 1e3 * (secs[long] - secs[short]) / (long - short)}
    W, sched = arms["schedule"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        counted(run_classification, X[:n_train], y[:n_train], idx, W, schedule=sched,
                steps=short, **kw)
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0 and "HtoD" not in e.key:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / short
    out["schedule"]["device_ms_per_step"] = sum(per_kernel.values())
    out["schedule"]["top_kernels_ms_per_step"] = dict(
        sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    return out


def phase_cross_device() -> None:
    """The card against the CPU's plain path on a small input (n = 16)."""
    task = mean_estimation_clusters(16, K=4, m=2.0)
    res = learn_topology(task.Pi, budget=3, lam=0.5)
    sched = schedule_from_result(res)
    for kw in ({"W": res.W}, {"W": None, "schedule": sched}):
        gpu = run_mean_estimation(task, steps=20, lr=0.2, device="cuda", **kw)
        cpu = run_mean_estimation(task, steps=20, lr=0.2, device="cpu", **kw)
        err = float(np.abs(gpu["mean_sq_error"] - cpu["mean_sq_error"]).max())
        print(f"# 2d mean estimation cuda vs cpu ({'W' if kw['W'] is not None else 'schedule'})"
              f": max |diff| {err:.3e}")
        check(np.allclose(gpu["mean_sq_error"], cpu["mean_sq_error"], rtol=1e-5, atol=1e-6),
              "2d: cuda and cpu error traces disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"# 0 {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"kernels built in {build_s:.1f} s")

    mnist = mnist_width_data()
    rows = phase_kernels(mnist[3])
    for r in rows:
        print("# 1 " + json.dumps(r))
    launches = phase_main_path(mnist)
    phase_cross_device()
    for arm, r in step_breakdown(mnist).items():
        print(f"# 2e {arm} " + json.dumps(r))

    kernels = []
    for name, meta in KERNELS.items():
        head = next(r for r in rows if r["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": [head["n"], head["P"]], "dtype": head["dtype"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
