#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--save-table PATH]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels`` (one
nvcc per source, all at once) and then, on the card:

0. prints the card (``nvidia-smi``), the torch and CUDA versions and the
   kernels' build time;
1. holds each kernel against its plain PyTorch version on the same
   inputs, at the main paths' shapes, with the reference's tolerances
   (gossip: float32 1e-5; flash attention: float32 2e-3; RG-LRU scan:
   float32 1e-4; bfloat16 3e-2, but 1e-2 for flash attention, whose
   outputs over a 2048 window are ~0.04), and times the kernel, the plain
   version and one library call computing the same function (median of
   30 launches, CUDA events); it also prints which kernel design ran
   (gossip_schedule: a shared-memory tile in float32, the L2 gather in
   bfloat16 and for n = 4096; gossip_mix and flash_attention: by dtype
   and n; rglru_scan: its tiling, with a 32768-step case for a long
   look-back chain), and the headline rows of gossip_schedule, gossip_mix
   and flash_attention must be faster than the library call; two launches
   of rglru_scan on the same inputs must be bitwise equal (every scan
   case, and bfloat16 at (2, 4096, 2560) and (2, 32768, 2560)); the
   flash rows include phase 8's layers (qwen3-0.6b, qwen2.5-14b, gemma-2b,
   gemma2-2b local at S = 8192 and global, softcap 50; SDPA has no
   softcap, so those rows time it without one, beside the row); the
   device auction LMO on the cold and warm STL-FW gradients of phase 6b's
   label-shard Pi (n = 100), of a Dirichlet(0.1) label partition at n =
   128, 512, 1024 and 2048, and on tied integers: its assignment, prices
   and counters identical to the plain version's (run on the host, in
   worker processes), its objective scipy's within 1e-9; the kernel's ms
   beside the whole call's, the plain version's, the numpy auction's and
   scipy's (host times the median of 3, taken with no worker running);
2. drives the D-SGD main path through the user's entry points -- Pi from
   a label-skew partition, ``learn_topology``, ``schedule_from_result``,
   ``run_classification`` / ``run_mean_estimation`` on ``cuda`` -- and
   checks accuracies, losses, errors and the kernels' launch counts;
   ``learn_topology(lmo="auction_jit")`` at n = 512, budget 64, against
   ``lmo="scipy"`` (the objective and step-size traces within 1e-9); 2d,
   the transport table: ``autotune_transport(measure=True)`` over n 64-
   2048 x L 2-64 into a temporary file (``--save-table`` copies it out),
   each bucket's two transport times (``mix_stacked`` on a pytree of
   phase 2b's leaf widths) beside the closed form's pick; phase 6b holds
   the pick at phase 2b's bucket to the two arms' ms/step;
3. scores sequences with recurrentgemma-2b at its full width (random
   weights from seed 0, bfloat16, B = 2, S = 4096) through
   ``registry.loss_fn`` / ``model_forward``: 8 flash_attention and 18
   rglru_scan launches a forward, the loss against the plain path, against
   a float64 cross entropy of the forward's logits and above ln(vocab) - 1
   (random labels); then the same model in float32 at depth 3, kernel
   path against plain path; tokens/s and the device busy share;
4. serves it: ``serve.engine.generate`` (B = 2, a 2560-token prompt, 32
   new tokens: the prompt overruns the 2048 window, so the prefill takes
   the chunked attention and the ring clamp, and decode wraps the ring),
   whose decode step is a CUDA graph, against an eager loop over
   ``decode_step``: identical tokens, each step's logits bitwise equal,
   one capture; prefill launches; graph and eager decode ms/token
   (``generate`` less its prefill), device busy shares, device operations
   per token, the capture's ms; 4b, decode consistency in float32 at
   depth 3 through the decoder (three steps: warm-up, capture, replay);
5. runs the smoke config's kernel path on the card against its plain
   path on the CPU;
6. drives the captured D-SGD rollout (``rollout="scan"``: CUDA graphs)
   and online topology adaptation: both gossip kernels captured in a
   graph and swapped by ``copy_``; 6a, the reference's online acceptance
   run (abrupt label swap, frozen / oracle / online arms: log-space
   recovery >= 0.8, one capture per arm); 6b, phase 2b's MNIST-width MLP
   on a ``ScheduleArrays`` with an ``OnlineTopologyController`` (inline:
   graph against loop, equal losses and swaps, one capture; overlap:
   every swap collected without blocking, a final flush), and, printed,
   loop against graph ms/step and device busy share on phase 2b's arms
   (the transport phase 2d's table picks there must be within 5% of the
   faster arm's graph ms/step); 6c, a cold solve and a warm STL-FW refresh at n = 512 with the scipy
   and the device LMO (equal objectives), and 6b's controller with the
   device LMO, inline and in overlap mode (one capture an arm);
7. drives the robustness layer in the captured rollout: 7a, phase 6b's
   run with health probes (tau_bar at the controller's live Pi_hat)
   bitwise the probes-off run, and the probes' cost per step; 7b, phase
   2b's shape with a swap under the wires none / identity / bf16 /
   topk:0.1:g0.25 (identity bitwise none, bf16 half the bytes, top-k
   k * 8, graph bitwise loop); 7c, bounded-delay gossip there (zero
   delays bitwise fresh; wait, degrade, wait + bf16) and its ms per step;
   7d, ``run_faulty_mean_estimation`` at ``benchmarks/bench_faults.py``'s
   sizes: a fault-sweep cell, the straggler bars (wait 1.1x, degrade
   1.2x of fault-free), the corruption bar (1.2x, all four modes), the
   crash-recovery drill resumed bitwise; one capture an arm;
8. drives each dense GQA family (qwen3-0.6b, gemma-2b, gemma2-2b,
   qwen2.5-14b) at its published widths and full depth, one at a time,
   random bf16 weights from seed 0: scoring at B = 2, S = 4096 (one
   flash_attention launch per attention layer and forward: 28 / 18 / 26
   / 48; the loss within 1e-2 of the plain path and above ln(vocab) -
   1), f32 at depth 3 (kernel against plain path at 1e-4, decode through
   the decoder within 2e-3 of the full forward), serving as in phase 4
   (a 2560-token prompt, gemma2 4608 to overrun its 4096 window; 32 new
   tokens; graph against eager), and the phase's seconds;
9. prints one JSON line per kernel set, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.

Every ``#`` result line ends with the card's name and power limit.
Any failed check raises, so the script exits non-zero and prints no
result; so it does without CUDA or outside a checkout of the repo.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.assignment import _quantize, auction_assignment  # noqa: E402
from repro_torch.core.assignment_jit import AuctionWorkspace, auction_assignment_jit  # noqa: E402
from repro_torch.core.mixing import (  # noqa: E402
    ScheduleArrays,
    StragglerPolicy,
    _bucket_key,
    arrays_to_matrix,
    autotune_transport,
    preferred_transport,
    schedule_from_result,
    schedule_to_arrays,
)
from repro_torch.core.stl_fw import LMOSolver, learn_topology  # noqa: E402
from repro_torch.data.drift import AbruptLabelSwap, labels_stream  # noqa: E402
from repro_torch.data.partition import dirichlet_partition, shard_partition  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs, mean_estimation_clusters  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.auction import ops as auction_ops  # noqa: E402
from repro_torch.kernels.auction.ref import STATS as AUCTION_STATS  # noqa: E402
from repro_torch.kernels.auction.ref import auction_ref  # noqa: E402
from repro_torch.kernels.gossip_mix import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.gossip_mix.ref import gossip_mix_ref, gossip_schedule_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.faults import run_faulty_mean_estimation  # noqa: E402
from repro_torch.obs import HealthProbes, Tracer  # noqa: E402
from repro_torch.online import (  # noqa: E402
    OnlineTopologyController,
    RefreshConfig,
    StreamingPiEstimator,
    TopologyRefresher,
)
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.trainer import run_classification, run_mean_estimation  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12  # float32 inputs on the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# bf16 flash outputs over a 2048-key window are ~0.04: 3e-2 would hold
# nothing, 1e-2 is a few bf16 ulps of them
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
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
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:109",
    },
    "rglru_scan": {
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:56",
    },
    # no Pallas counterpart: the reference's lax.while_loop auction
    "auction": {
        "source": "src/repro_torch/kernels/auction/csrc/auction.cu",
        "replaces": "src/repro/core/assignment_jit.py:184",
    },
}


@functools.cache
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def note(line: str) -> None:
    """Print a result line with the card's name and power limit beside it."""
    print(f"{line} | {card()}", flush=True)


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
    """Least time of ``out = W @ theta`` in ms, and what bounds it. float32
    at the 1e-5 parity needs three TF32 products on the tensor cores
    (3xTF32), whichever kernel runs; bfloat16 one bf16 product."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * n * P + n * n) * s / HBM_BYTES_PER_S
    if dtype == torch.float32:
        t_ops = 3 * 2 * n * n * P / PEAK_TF32_OPS_PER_S
    else:
        t_ops = 2 * n * n * P / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _theta(n: int, P: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, P), generator=gen, device="cuda").to(dtype)


def _compare(name: str, out: torch.Tensor, plain: torch.Tensor, dtype, tols=TOL) -> float:
    torch.cuda.synchronize()
    check(out.shape == plain.shape and out.dtype == plain.dtype, f"{name}: shape/dtype")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    tol = tols[dtype]
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
        "dtype": str(dtype).replace("torch.", ""),
        "design": ops.gossip_schedule_design(n, L, dtype), "max_abs_err": err,
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
    design = ops.gossip_mix_design(n, dtype)
    bound, bound_by = mix_bound(n, P, dtype)
    row = {
        "kernel": "gossip_mix", "case": label, "n": n, "P": P,
        "dtype": str(dtype).replace("torch.", ""), "design": design,
        "max_abs_err": err,
        "kernel_ms": device_ms(lambda: ops.gossip_mix(theta, W)),
        "plain_ms": device_ms(lambda: gossip_mix_ref(theta, Wc)),
        "library_ms": device_ms(lambda: torch.matmul(Wc, theta)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["TFLOP_per_s"] = 2 * n * n * P / row["kernel_ms"] / 1e9
    return row


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def kept_pairs(S: int, window: int | None) -> int:
    """(q, k) pairs a causal, optionally windowed attention keeps."""
    return int(np.minimum(np.arange(1, S + 1), window or S).sum())


def flash_bound(B: int, S: int, H: int, Hkv: int, D: int, window: int | None,
                dtype: torch.dtype) -> tuple[float, str]:
    """Least time of causal windowed GQA attention in ms, and what bounds it:
    q, k, v read once and out written once; 4 D flops per kept pair and head."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * s / HBM_BYTES_PER_S
    t_ops = 4 * D * kept_pairs(S, window) * B * H / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_bound(B: int, S: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of the linear scan in ms: a and b read once, h written once
    (2 flops an element, far below the bytes)."""
    s = torch.finfo(dtype).bits // 8
    t_bytes = 3 * B * S * D * s / HBM_BYTES_PER_S
    t_ops = 2 * B * S * D / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _randn(shape, dtype: torch.dtype, seed: int, scale: float = 1.0) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def flash_case(label: str, B: int, S: int, H: int, Hkv: int, D: int, window: int | None,
               dtype: torch.dtype, seed: int, softcap: float = 0.0) -> dict:
    q = _randn((B, S, H, D), dtype, seed)
    k = _randn((B, S, Hkv, D), dtype, seed + 1)
    v = _randn((B, S, Hkv, D), dtype, seed + 2)
    kw = dict(window=window, softcap=softcap)
    out = fa_ops.flash_attention(q, k, v, **kw)
    plain = flash_attention_ref(q, k, v, **kw)
    err = _compare(f"flash_attention {label}", out, plain, dtype, FLASH_TOL)
    # the library yardstick: SDPA with k / v expanded to H heads and an
    # explicit boolean band mask (timed only; the port never calls it). SDPA
    # has no softcap: with one it computes another function, so it is timed
    # beside the row and library_ms stays None
    g = H // Hkv
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    pos = torch.arange(S, device="cuda")
    band = pos[None, :] <= pos[:, None]
    if window is not None:
        band = band & (pos[None, :] > pos[:, None] - window)
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band).transpose(1, 2)
    bound, bound_by = flash_bound(B, S, H, Hkv, D, window, dtype)
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band))
    row = {
        "kernel": "flash_attention", "case": label, "shape": [B, S, H, Hkv, D],
        "window": window, "softcap": softcap, "dtype": _name(dtype),
        "design": fa_ops.kernel_design(dtype), "max_abs_err": err,
        "library_max_abs_err":
            None if softcap else float((lib.float() - plain.float()).abs().max()),
        "kernel_ms": device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw)),
        "plain_ms": device_ms(lambda: flash_attention_ref(q, k, v, **kw)),
        "library_ms": None if softcap else sdpa_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    if softcap:
        row["sdpa_without_softcap_ms"] = sdpa_ms
    row["TFLOP_per_s"] = 4 * D * kept_pairs(S, window) * B * H / row["kernel_ms"] / 1e9
    return row


def scan_case(label: str, B: int, S: int, D: int, dtype: torch.dtype, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((B, S, D), generator=gen, device="cuda") * 0.399 + 0.6).to(dtype)
    b = (torch.randn((B, S, D), generator=gen, device="cuda") * 0.2).to(dtype)
    out = scan_ops.rglru_scan(a, b)
    plain = rglru_scan_ref(a, b)
    err = _compare(f"rglru_scan {label}", out, plain, dtype, SCAN_TOL)
    check(torch.equal(scan_ops.rglru_scan(a, b), out),
          f"rglru_scan {label} {_name(dtype)}: two launches on the same inputs differ")
    bound, bound_by = scan_bound(B, S, D, dtype)
    row = {
        "kernel": "rglru_scan", "case": label, "shape": [B, S, D], "dtype": _name(dtype),
        "design": scan_ops.kernel_design(), "max_abs_err": err, "bitwise_rerun": True,
        "kernel_ms": device_ms(lambda: scan_ops.rglru_scan(a, b)),
        "plain_ms": device_ms(lambda: rglru_scan_ref(a, b)),
        "library_ms": None,  # no single PyTorch call computes a linear recurrence
        "bound_ms": bound, "bound_by": bound_by,
    }
    row["GB_per_s"] = 3 * B * S * D * a.element_size() / row["kernel_ms"] / 1e6
    return row


def scan_determinism(B: int, S: int, D: int, dtype: torch.dtype, seed: int) -> None:
    """Three launches of the scan on one input give the same bits (each
    ``scan_case`` checks two)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((B, S, D), generator=gen, device="cuda") * 0.399 + 0.6).to(dtype)
    b = (torch.randn((B, S, D), generator=gen, device="cuda") * 0.2).to(dtype)
    first = scan_ops.rglru_scan(a, b)
    for _ in range(2):
        check(torch.equal(scan_ops.rglru_scan(a, b), first),
              f"rglru_scan ({B}, {S}, {D}) {_name(dtype)}: launches differ")
    note(f"# 1 rglru_scan ({B}, {S}, {D}) {_name(dtype)}: three launches bitwise equal")


def phase_lm_kernels() -> list[dict]:
    """The LM kernels' cases; the first row of each kernel is its headline
    (recurrentgemma-2b's full-width shapes)."""
    bf16, f32 = torch.bfloat16, torch.float32
    scan_determinism(2, 4096, 2560, bf16, 36)
    scan_determinism(2, 32768, 2560, bf16, 37)
    return [
        flash_case("recurrentgemma-2b layer", 2, 4096, 10, 1, 256, 2048, bf16, 20),
        # the dense families' layers (phase 8's scoring shapes)
        flash_case("qwen3-0.6b layer", 2, 4096, 16, 8, 128, None, bf16, 40),
        flash_case("qwen2.5-14b layer", 2, 4096, 40, 8, 128, None, bf16, 43),
        flash_case("gemma-2b layer", 2, 4096, 8, 1, 256, None, bf16, 46),
        flash_case("gemma2-2b local layer, S=8192", 2, 8192, 8, 4, 256, 4096, bf16, 49,
                   softcap=50.0),
        flash_case("gemma2-2b global layer", 2, 4096, 8, 4, 256, None, bf16, 52, softcap=50.0),
        flash_case("recurrentgemma-2b layer", 2, 4096, 10, 1, 256, 2048, f32, 21),
        flash_case("f32, S=1024", 1, 1024, 10, 1, 256, 2048, f32, 23),
        flash_case("S=100 ragged", 2, 100, 10, 1, 256, 2048, f32, 26),
        flash_case("S=100 ragged", 2, 100, 10, 1, 256, 2048, bf16, 29),
        scan_case("recurrentgemma-2b layer", 2, 4096, 2560, f32, 32),
        scan_case("ragged S and D", 3, 1001, 2561, f32, 33),
        scan_case("ragged S and D", 3, 1001, 2561, bf16, 34),
        scan_case("long look-back", 2, 32768, 2560, f32, 35),
    ]


def random_atoms(n: int, L: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """L atoms on n nodes: the identity and L - 1 random permutations with
    positive weights summing to 1 (a schedule too large to learn here)."""
    rng = np.random.default_rng(seed)
    perms = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)])
    g = rng.random(L) + 0.1
    return (torch.as_tensor(g / g.sum(), dtype=torch.float32, device="cuda"),
            torch.as_tensor(perms, dtype=torch.int32, device="cuda"))


def phase_kernels(Pi_mnist: np.ndarray) -> list[dict]:
    """Every kernel case; the first row of each kernel is its headline."""
    res100 = learn_topology(Pi_mnist, budget=10, lam=0.1)
    s100 = schedule_from_result(res100)
    g100, p100 = s100.operands("cuda")
    res512 = learn_topology(dirichlet_pi(512), budget=8, lam=0.1)
    s512 = schedule_from_result(res512)
    padded = schedule_to_arrays(s100, l_max=s100.n_atoms + 5, device="cuda")
    s64 = schedule_from_result(learn_topology(np.eye(8)[np.arange(64) % 8], budget=8, lam=0.5))
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
        # phase 6a: n = 64 scalar parameters (rows padded to 8), l_max 17
        schedule_case("phase-6a mean estimation", _theta(64, 8, torch.float32, 12),
                      *schedule_to_arrays(s64, l_max=s64.n_atoms + 8, device="cuda")),
        # too many rows for a shared-memory tile: the l2-gather kernel
        schedule_case("n=4096 l2 gather", _theta(4096, 2**14 + 5, torch.float32, 11),
                      *random_atoms(4096, 9, 11)),
        mix_case("P=50890", _theta(100, P_mlp, torch.float32, 7), W100),
        mix_case("P=50890", _theta(100, P_mlp, torch.bfloat16, 8), W100),
        mix_case("n=512", _theta(512, 2**18 + 37, torch.float32, 9), W512),
    ]
    for leaf, size in (("w1", 784 * 64), ("b1", 64), ("w2", 640), ("b2", 10)):
        rows.append(mix_case(f"phase-2b leaf {leaf}", _theta(100, size, torch.float32, 10), W100))
    return rows


# ---------------------------------------------------------------------------
# Phase 1 (continued): the device auction LMO
# ---------------------------------------------------------------------------

# n = 100 is phase 6b's controller on its own label-shard Pi (not a
# multiple of 64: partial warps and lane loops); the others are
# Dirichlet(0.1) label partitions
AUCTION_SIZES = (100, 128, 512, 1024, 2048)
AUCTION_LAUNCHES = 5  # a solve is one launch of up to ~0.5 s: fewer than 30 timed
AUCTION_REPEATS = 3  # host yardsticks: the median of 3, timed with no worker running
AUCTION_HEADLINE = 512  # the warm solve at n = 512 (phase 6c's and phase 2's n)


class _GradRecorder(LMOSolver):
    """The scipy LMO, keeping each STL-FW gradient it is given."""

    def __init__(self):
        super().__init__("scipy")
        self.grads = []

    def __call__(self, grad):
        self.grads.append(np.array(grad, dtype=np.float64))
        return super().__call__(grad)


def fw_gradients(n: int, Pi: np.ndarray | None = None,
                 steps: int = 3) -> tuple[np.ndarray, np.ndarray, float]:
    """Two consecutive STL-FW gradients of ``Pi`` (None:
    ``dirichlet_pi(n, alpha=0.1)``) and the contraction ``1 - gamma``
    between them: a cold and a warm LMO solve as ``learn_topology`` makes
    them."""
    rec = _GradRecorder()
    Pi = dirichlet_pi(n, alpha=0.1) if Pi is None else Pi
    res = learn_topology(Pi, budget=steps, lam=0.1, lmo=rec)
    k = steps - 2
    return rec.grads[k], rec.grads[k + 1], 1.0 - float(res.gamma_trace[k])


def auction_bound(n: int, phases: int) -> tuple[float, str]:
    """Least time of a solve in ms: one pass over the float64 cost matrix
    per phase (and the prepare pass) at the memory rate, beside the
    vectors read and written once; bytes bound it."""
    t_bytes = ((max(phases, 1) + 1) * n * n * 8 + 28 * n) / HBM_BYTES_PER_S
    return 1e3 * t_bytes, "bytes"


def _objective(cost: np.ndarray, col) -> float:
    col = np.asarray(col)
    return float(cost[np.arange(len(col)), col].sum())


def _auction_kw(n: int, scale: float, have_warm: bool) -> dict:
    """The LMO's solve on the card: validate=False, Jacobi above 64 bidders."""
    return dict(warm_scale=scale, have_warm=have_warm, rel_grid=1e-12, scaling=3000.0,
                forward_reverse=False, validate=False, gs_threshold=64,
                max_iters=500 * n + 200_000)


def plain_auction_job(cost: np.ndarray, warm, kw: dict) -> tuple:
    """The plain version on the host (a worker process: its branches read
    every scalar back, ~0.1 ms a bid on the host, ~0.3 ms on the card)."""
    torch.set_num_threads(1)
    n = cost.shape[0]
    if warm is None:
        warm = (np.zeros(n), np.full(n, -1, dtype=np.int32))
    t0 = time.perf_counter()
    out = auction_ref(torch.from_numpy(cost), torch.from_numpy(warm[0]),
                      torch.from_numpy(warm[1]), **kw)
    return tuple(x.numpy() for x in out) + (time.perf_counter() - t0,)


def _median_ms(fn, repeats: int = AUCTION_REPEATS):
    """``fn()``'s last result and the median of its host ms over ``repeats``."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.median(times))


def auction_case(n: int, Pi: np.ndarray | None) -> dict:
    """Cold and warm FW-gradient solves at n on the card: the kernel's
    results, the objective held to scipy's, and the host times -- a whole
    ``auction_assignment_jit`` (the pinned copy up, the launch, the
    read-back), scipy and the numpy auction (warm-started as the LMO
    does) -- each the median of ``AUCTION_REPEATS``, taken while no
    worker runs. Device times and the plain version come later."""
    g0, g1, scale = fw_gradients(n, Pi)
    c0 = torch.as_tensor(g0, dtype=torch.float64, device="cuda")
    c1 = torch.as_tensor(g1, dtype=torch.float64, device="cuda")
    ws = AuctionWorkspace(n, "cuda")
    unset = (torch.zeros(n, dtype=torch.float64, device="cuda"),
             torch.full((n,), -1, dtype=torch.int32, device="cuda"))
    kw0, kw1 = _auction_kw(n, 1.0, False), _auction_kw(n, scale, True)
    cold = tuple(x.clone() for x in auction_ops.auction(c0, *unset, **ws.buffers, **kw0))
    warm_in = (cold[1].clone(), cold[0].clone())
    warm = tuple(x.clone() for x in auction_ops.auction(c1, *warm_in, **ws.buffers, **kw1))
    torch.cuda.synchronize()
    # the warm state's prices stay on a workspace of their own, so every
    # timed warm solve starts from the same cold prices
    lmo, held = AuctionWorkspace(n, "cuda"), AuctionWorkspace(n, "cuda")
    (col_cold, _), solve_cold = _median_ms(
        lambda: auction_assignment_jit(g0, validate=False, workspace=lmo))
    _, state = auction_assignment_jit(g0, validate=False, workspace=held)
    (col_warm, _), solve_warm = _median_ms(
        lambda: auction_assignment_jit(g1, state.scaled(scale), validate=False, workspace=lmo))
    check(np.array_equal(col_cold, cold[0].cpu().numpy()) and
          np.array_equal(col_warm, warm[0].cpu().numpy()),
          f"1 auction n={n}: auction_assignment_jit does not return the kernel's assignment")
    q0, q1 = _quantize(g0, 1e-12)[0], _quantize(g1, 1e-12)[0]
    (_, np_state), np_cold = _median_ms(lambda: auction_assignment(q0))
    _, np_warm = _median_ms(lambda: auction_assignment(q1, np_state.scaled(scale)))
    pi_name = "Dirichlet(0.1)" if Pi is None else "phase 6b's label shards"
    rows = []
    for kind, cost, k, solve_ms, np_ms in (("cold", g0, cold, solve_cold, np_cold),
                                           ("warm", g1, warm, solve_warm, np_warm)):
        ref_col, scipy_ms = _median_ms(lambda: linear_sum_assignment(cost)[1])
        obj, ref_obj = _objective(cost, k[0].cpu().numpy()), _objective(cost, ref_col)
        check(abs(obj - ref_obj) <= 1e-9 * max(1.0, abs(ref_obj)),
              f"1 auction n={n} {kind}: objective {obj!r} is not scipy's {ref_obj!r}")
        stats = dict(zip(AUCTION_STATS, k[2].tolist()))
        bound, bound_by = auction_bound(n, stats["phases"])
        rows.append({
            "kernel": "auction", "case": f"n={n} {kind} FW-gradient solve, {pi_name} Pi",
            "n": n, "shape": [n, n], "dtype": "float64", "phases": stats["phases"],
            "rounds": stats["rounds"], "rebid_rows": stats["rebid"], "solve_ms": solve_ms,
            "scipy_ms": scipy_ms, "numpy_auction_ms": np_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": bound_by, "objective_minus_scipy": obj - ref_obj,
            "kernel_out": tuple(x.cpu().numpy() for x in k),
        })
    timed = {"cold": (c0, unset, kw0), "warm": (c1, warm_in, kw1)}
    plain = {"cold": (g0, None, kw0), "warm": (g1, tuple(x.cpu().numpy() for x in warm_in), kw1)}
    return {"n": n, "rows": rows, "ws": ws, "timed": timed, "plain": plain}


def _time_kernel(case: dict) -> None:
    """The kernel's device ms (CUDA events) of each row of ``case``."""
    ws = case["ws"]
    for row, kind in zip(case["rows"], ("cold", "warm")):
        cost, warm, kw = case["timed"][kind]
        row["kernel_ms"] = device_ms(lambda: auction_ops.auction(cost, *warm, **ws.buffers, **kw),
                                     launches=AUCTION_LAUNCHES, warmup=1)


def _collect_auction(case: dict, jobs: list) -> None:
    """The plain version's results beside the kernel's: identical
    assignment, prices and counters."""
    for row, job in zip(case["rows"], jobs):
        plain = job.result()
        kernel = row.pop("kernel_out")
        for name, a, b in zip(("col_of_row", "prices", "stats"), kernel, plain[:3]):
            check(np.array_equal(a, b), f"1 auction {row['case']}: the kernel's {name} is not "
                  f"the plain version's (kernel stats {kernel[2].tolist()}, plain "
                  f"{plain[2].tolist()})")
        row.update({"max_abs_err": float(np.abs(kernel[1] - plain[1]).max()),
                    "plain_ms": 1e3 * plain[3], "plain_on": "host"})


def auction_tied_case(n: int = 128) -> tuple:
    """Small-integer costs (exact ties: the price wars the rescue ends),
    Jacobi rounds carrying the bidding: the kernel's results, checked
    against scipy's objective here and the plain version's later."""
    cost = np.random.default_rng(3).integers(0, 3, size=(n, n)).astype(np.float64)
    kw = _auction_kw(n, 1.0, False)
    ws = AuctionWorkspace(n, "cuda")
    k = auction_ops.auction(torch.as_tensor(cost, device="cuda"),
                            torch.zeros(n, dtype=torch.float64, device="cuda"),
                            torch.full((n,), -1, dtype=torch.int32, device="cuda"),
                            **ws.buffers, **kw)
    k = tuple(x.cpu().numpy() for x in k)
    check(_objective(cost, k[0]) == _objective(cost, linear_sum_assignment(cost)[1]),
          "1 auction tied integers: objective is not scipy's")
    return cost, kw, k


def phase_auction(Pi_mnist: np.ndarray) -> list[dict]:
    """Phase 1's auction rows (the headline first: the warm solve at
    n = 512). The host yardsticks are timed first, with no worker
    running; then the plain version runs in worker processes while the
    card is timed."""
    import concurrent.futures
    import multiprocessing

    cases = [auction_case(n, Pi_mnist if n == len(Pi_mnist) else None)
             for n in AUCTION_SIZES]
    tied_cost, tied_kw, tied = auction_tied_case()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
        jobs = [[pool.submit(plain_auction_job, *c["plain"][kind]) for kind in ("cold", "warm")]
                for c in cases]
        tied_job = pool.submit(plain_auction_job, tied_cost, None, tied_kw)
        for c in cases:
            _time_kernel(c)
        rows = []
        for c, case_jobs in zip(cases, jobs):
            _collect_auction(c, case_jobs)
            rows += c["rows"]
        plain = tied_job.result()
    for name, a, b in zip(("col_of_row", "prices", "stats"), tied, plain[:3]):
        check(np.array_equal(a, b),
              f"1 auction tied integers: the kernel's {name} is not the plain version's")
    note(f"# 1 auction n={len(tied_cost)} tied integer costs: identical to the plain version, "
         f"scipy's objective; stats {dict(zip(AUCTION_STATS, tied[2].tolist()))}, plain "
         f"version {plain[3]:.2f} s on the host")
    head = next(r for r in rows if r["n"] == AUCTION_HEADLINE and "warm" in r["case"])
    return [head] + [r for r in rows if r is not head]


# ---------------------------------------------------------------------------
# Phase 2: the main path through the user's entry points
# ---------------------------------------------------------------------------

def reset_launch_counts() -> None:
    for mod in (ops, fa_ops, scan_ops, auction_ops):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    return {**ops.launch_counts, **fa_ops.launch_counts, **scan_ops.launch_counts,
            **auction_ops.launch_counts}


def counted(fn, *args, **kwargs):
    """``fn(...)`` with every launch count set to 0 just before it; returns
    (result, counts, wall seconds)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, launch_counts(), time.perf_counter() - t0


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
        check(counts == {"gossip_schedule": schedule, "gossip_mix": mix,
                         "flash_attention": 0, "rglru_scan": 0, "auction": 0},
              f"{label}: launches {counts}, expected schedule={schedule} mix={mix}")
        for k in launches:
            launches[k] += counts[k]
        note(f"# 2 {label}: launches {counts}")

    a = fig2_protocol()
    expect("2a stl-fw(d2) schedule, 150 steps", a["stl_counts"], 150, 0)
    expect("2a random(d2) dense, 150 steps x 2 leaves", a["random_counts"], 0, 300)
    ref_acc = fig2_reference_acc()
    note(f"# 2a acc_mean stl-fw(d2)={a['stl']['acc_mean']:.4f} "
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
        note(f"# 2b {arm}: acc_mean={r['final']['acc_mean']:.4f} "
              f"loss {loss[:10].mean():.4f} -> {loss[-10:].mean():.4f} "
              f"consensus={r['final']['consensus']:.4g} {r['steps_per_s']:.1f} steps/s "
              f"({r['seconds']:.2f} s with setup and 2 evals)")
        check(bool(np.isfinite(loss).all()), f"2b {arm}: non-finite loss")
        check(loss[-10:].mean() < loss[:10].mean(), f"2b {arm}: loss did not fall")
        check(r["final"]["acc_mean"] > 0.5, f"2b {arm}: acc_mean <= 0.5")

    c = mean_estimation()
    expect("2c mean estimation stl-fw W, 100 steps", c["stl_counts"], 0, 100)
    expect("2c mean estimation random(d9), 100 steps", c["random_counts"], 0, 100)
    note(f"# 2c mean_sq_error stl-fw {c['stl'][0]:.5f} -> {c['stl'][-1]:.5f}, "
          f"random(d9) final {c['random'][-1]:.5f}")
    check(bool(np.isfinite(c["stl"]).all()), "2c: non-finite error")
    check(c["stl"][-1] < c["stl"][0], "2c: final mean_sq_error is not below the first")
    check(c["stl"][-1] < 0.5 * c["random"][-1], "2c: stl-fw is not 2x below random(d9)")
    launches["auction"] = phase_device_lmo()
    return launches


def step_breakdown(data, short: int = 20, long: int = 120) -> dict:
    """Phase 2e: where a phase-2b step's time goes in the eager loop
    (``rollout="loop"``; phase 6b sets the graph beside it).

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
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda",
              rollout="loop")
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
        note(f"# 2d mean estimation cuda vs cpu ({'W' if kw['W'] is not None else 'schedule'})"
              f": max |diff| {err:.3e}")
        check(np.allclose(gpu["mean_sq_error"], cpu["mean_sq_error"], rtol=1e-5, atol=1e-6),
              "2d: cuda and cpu error traces disagree")


def phase_device_lmo() -> int:
    """Phase 2 (continued): ``learn_topology(lmo="auction_jit")`` at n = 512,
    budget 64, on a generic Pi (Dirichlet(0.1), K = 64), against
    ``lmo="scipy"``: the objective and step-size traces within 1e-9 (the
    reference test's bar; atoms may differ where the LMO has exact ties).
    Returns the auction's launches: one a FW step and the final gap."""
    n, K, budget = 512, 64, 64
    Pi = np.random.default_rng(0).dirichlet(0.1 * np.ones(K), size=n)
    ref, _, scipy_s = counted(learn_topology, Pi, budget=budget, lam=0.1, lmo="scipy")
    jit, counts, jit_s = counted(learn_topology, Pi, budget=budget, lam=0.1,
                                 lmo="auction_jit")
    same = sum(np.array_equal(a, b) for a, b in zip(jit.perms, ref.perms))
    obj_err = float(np.abs(jit.objective_trace - ref.objective_trace).max())
    gamma_err = float(np.abs(jit.gamma_trace - ref.gamma_trace).max())
    out = {"n": n, "budget": budget, "auction_jit_s": jit_s, "scipy_s": scipy_s,
           "launches": counts["auction"], "atoms": [len(jit.perms), len(ref.perms)],
           "atoms_identical": int(same), "objective_max_abs_diff": obj_err,
           "gamma_max_abs_diff": gamma_err, "objective_final": float(jit.objective_trace[-1]),
           "lmo_backend": jit.lmo_backend}
    note("# 2 learn_topology auction_jit against scipy " + json.dumps(out))
    check(jit.lmo_backend == "auction_jit", "2: learn_topology does not report auction_jit")
    check(counts["auction"] == len(jit.gap_trace),
          f"2: {counts['auction']} auction launches for {len(jit.gap_trace)} LMO solves")
    check(len(jit.objective_trace) == len(ref.objective_trace) and obj_err <= 1e-9
          and gamma_err <= 1e-9, "2: the auction_jit trajectory is not scipy's")
    return counts["auction"]


TABLE_NODES = (64, 128, 256, 512, 1024, 2048)
TABLE_ATOMS = (2, 4, 8, 16, 32, 64)
TABLE_LEAVES = (50176, 64, 640, 10)  # phase 2b's MLP leaves per node: w1, b1, w2, b2
TABLE_P = sum(TABLE_LEAVES)  # 50890; bucket 65536
END_TO_END_NOISE = 1.05  # the two arms of 6b's graph ms/step have differed by up to 4.5%


def phase_transport_table(Pi_2b: np.ndarray, save: str | None = None) -> dict:
    """Phase 2d: the transport table on the card. ``autotune_transport``
    measures every (n, L) bucket of the grid (L < n, P bucketed and
    capped as the reference caps it) into a temporary table -- never the
    committed one -- timing both transports through ``mix_stacked`` on a
    pytree of phase 2b's leaf widths, as the trainers run them; printed
    beside the closed form's pick. ``save`` copies the measured table
    there. Phase 6b holds the pick at 2b's bucket to its ms/step."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transport_autotune.json")
        for n in TABLE_NODES:
            for L in TABLE_ATOMS:
                if L < n:
                    autotune_transport(n, L, TABLE_P, measure=True, path=path, device="cuda",
                                       leaf_sizes=TABLE_LEAVES)
        with open(path) as f:
            table = json.load(f)
        if save:
            shutil.copyfile(path, save)
    seconds = time.perf_counter() - t0
    losses = []
    for key, r in sorted(table.items(), key=lambda kv: (kv[1]["n_nodes"], kv[1]["n_atoms"])):
        closed = preferred_transport(r["n_nodes"], r["n_atoms"])
        us = {"schedule": r["schedule_us"], "dense": r["dense_us"]}
        if closed != r["winner"]:
            losses.append(us[closed] / us[r["winner"]])
        note(f"# 2d n={r['n_nodes']} L={r['n_atoms']} P={r['p']} (timed {r['p_measured']}): "
             f"schedule {us['schedule']:.1f} us, dense {us['dense']:.1f} us, winner "
             f"{r['winner']}, closed form {closed}")
        check(r["card"] == torch.cuda.get_device_name(0) and r["power_limit"],
              f"2d {key}: the record does not name the card and its power limit")
    sched_2b = schedule_from_result(learn_topology(Pi_2b, budget=10, lam=0.1))
    head = table[_bucket_key(sched_2b.n_nodes, sched_2b.n_communication_atoms, TABLE_P,
                             torch.device("cuda"))]
    out = {"buckets": len(table), "disagree": len(losses),
           "largest_closed_form_loss": max(losses, default=1.0), "seconds": seconds,
           "phase_2b_bucket": {k: head[k] for k in ("n_nodes", "n_atoms", "p", "winner")}}
    note("# 2d transport table " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the captured rollout and online topology adaptation
# ---------------------------------------------------------------------------

def phase_capture_kernels() -> dict:
    """Both gossip kernels captured in one CUDA graph, their operands
    replaced by ``copy_`` and the graph replayed: equal to the plain
    versions (schedule bitwise, mix at 1e-5), as the captured rollout
    uses them, at phase 2b's shape. Launches made here are compared, not
    counted."""
    n, P, L = 100, 50896, 11
    theta = _theta(n, P, torch.float32, 40)
    g, p = random_atoms(n, L, 41)
    W = torch.as_tensor(arrays_to_matrix(ScheduleArrays(g, p)), dtype=torch.float32,
                        device="cuda")
    ops.gossip_schedule(theta, g, p)
    ops.gossip_mix(theta, W)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s = ops.gossip_schedule(theta, g, p)
        out_m = ops.gossip_mix(theta, W)
    errs = {}
    for swap in (False, True):
        if swap:
            g2, p2 = random_atoms(n, L, 42)
            g.copy_(g2)
            p.copy_(p2)
            theta.copy_(_theta(n, P, torch.float32, 43))
            W.copy_(torch.as_tensor(arrays_to_matrix(ScheduleArrays(g2, p2)),
                                    dtype=torch.float32, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out_s, gossip_schedule_ref(theta, g, p)),
              f"6 captured gossip_schedule (swap={swap}) is not bitwise the plain version")
        errs[f"mix_swap={swap}"] = _compare(f"6 captured gossip_mix (swap={swap})", out_m,
                                            gossip_mix_ref(theta, W), torch.float32)
    note(f"# 6 capture: both gossip kernels in one graph, operands swapped by copy_, "
          f"gossip_mix max err {errs}")
    return errs


def _feed(ctl, labels):
    """``on_segment`` hook: stream the labels up to ``t`` in, then ask. It
    exposes the controller's estimator, so a tau_bar probe reads the live
    Pi_hat at each boundary."""
    fed = {"t": 0}

    def hook(t):
        while fed["t"] <= t:
            ctl.observe(labels[fed["t"]])
            fed["t"] += 1
        return ctl.on_segment(t)

    hook.estimator = ctl.estimator
    return hook


def phase_drift_recovery(launches: dict) -> dict:
    """Phase 6a: the reference's online acceptance configuration
    (``benchmarks/bench_online.py`` ``_bench_recovery_and_retrace``,
    non-smoke): abrupt label swap at t = 200 on Section 6.1 mean estimation
    (n = 64, K = 8), frozen / oracle / online arms on one observation
    stream, all ``rollout="scan"`` on the card."""
    n, K, steps, seg, t_drift, budget = 64, 8, 600, 20, 200, 8
    lam, lr, batch, beta = 0.5, 0.05, 4, 0.2
    task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=1.0)
    Pi0 = np.eye(K)[np.arange(n) % K].astype(float)
    scenario = AbruptLabelSwap(Pi0, t_drift=t_drift,
                               node_perm=np.random.default_rng(11).permutation(n))
    labels = labels_stream(scenario, steps, batch, seed=0)
    zs = np.asarray(task.cluster_means)[labels] + np.sqrt(task.sigma_tilde2) * \
        np.random.default_rng(1).normal(size=labels.shape)
    res0 = learn_topology(Pi0, budget=budget, lam=lam)
    ref = TopologyRefresher(res0, RefreshConfig(budget=budget, lam=lam), device="cuda")
    sa0 = schedule_to_arrays(schedule_from_result(res0), ref.l_max, device="cuda")
    sa_oracle = schedule_to_arrays(
        schedule_from_result(learn_topology(scenario.Pi(t_drift), budget=budget, lam=lam)),
        ref.l_max, device="cuda")
    swapped = {"done": False}

    def oracle_hook(t):
        if not swapped["done"] and t >= t_drift - 1:
            swapped["done"] = True
            return sa_oracle
        return None

    ctl = OnlineTopologyController(
        ref, estimator=StreamingPiEstimator(n, K, beta=beta, init=Pi0))
    arms = {}
    for arm, hook in (("frozen", None), ("oracle", oracle_hook), ("online", _feed(ctl, labels))):
        out, counts, secs = counted(
            run_mean_estimation, task, None, steps=steps, lr=lr, batch=batch, seed=2,
            schedule=sa0, zs=zs, on_segment=hook, segment_len=seg, rollout="scan",
            device="cuda")
        check(counts["gossip_schedule"] == steps and counts["gossip_mix"] == 0,
              f"6a {arm}: launches {counts}, expected gossip_schedule={steps}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        check(out["n_traces"] == 1, f"6a {arm}: n_traces {out['n_traces']} != 1")
        check(bool(np.isfinite(out["mean_sq_error"]).all()), f"6a {arm}: non-finite error")
        arms[arm] = {"out": out, "seconds": secs}
    check(swapped["done"], "6a: the oracle arm never swapped")
    check(ref.n_refreshes >= 1 and len(arms["online"]["out"]["swaps"]) >= 1,
          "6a: the online arm never swapped")
    tail = slice(-max(10, steps // 12), None)
    err = {a: float(np.median(r["out"]["mean_sq_error"][tail])) for a, r in arms.items()}
    log_rec = (np.log(err["frozen"]) - np.log(err["online"])) / (
        np.log(err["frozen"]) - np.log(err["oracle"]))
    out = {"err": err, "recovery_log": float(log_rec),
           "recovery_linear": (err["frozen"] - err["online"]) / (err["frozen"] - err["oracle"]),
           "swaps": arms["online"]["out"]["swaps"], "n_refreshes": ref.n_refreshes,
           "n_traces": {a: r["out"]["n_traces"] for a, r in arms.items()},
           "seconds": {a: r["seconds"] for a, r in arms.items()}}
    note("# 6a " + json.dumps(out))
    check(log_rec >= 0.8, f"6a: log-space recovery {log_rec:.3f} < 0.8 of the frozen->oracle gap")
    return out


def _online_controller(Pi0: np.ndarray, res0, lmo: str = "auto", **kw):
    ref = TopologyRefresher(res0, RefreshConfig(budget=10, lam=0.1, l_max=11), lmo=lmo,
                            device="cuda")
    return OnlineTopologyController(ref, Pi0=Pi0, **kw)


def phase_online_full_width(data, launches: dict, steps: int = 200) -> dict:
    """Phase 6b: phase 2b's MNIST-width run (n = 100, MLP hidden 64, P =
    50890) on a ``ScheduleArrays`` (STL-FW budget 10, l_max 11), with an
    ``OnlineTopologyController`` observing a label stream that swaps at
    t = 100: inline in both rollouts (equal losses and swaps), then in
    overlap mode in the captured rollout."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    runs = {}
    for rollout in ("loop", "scan"):
        ctl = _online_controller(Pi0, res0)
        sa0 = ctl.schedule_arrays()
        log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                    schedule=sa0, on_segment=_feed(ctl, labels),
                                    rollout=rollout, **kw)
        check(counts["gossip_schedule"] == steps and counts["gossip_mix"] == 0,
              f"6b inline {rollout}: launches {counts}, expected gossip_schedule={steps}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        runs[rollout] = {"log": log, "seconds": secs, "refreshes": ctl.refresher.n_refreshes}
    loop, scan = runs["loop"]["log"], runs["scan"]["log"]
    l_loop, l_scan = loop.column("loss"), scan.column("loss")
    max_diff = float(np.abs(l_loop - l_scan).max())
    bitwise = bool(np.array_equal(l_loop, l_scan)) and loop.history == scan.history
    out = {"swaps": scan.aux["swaps"], "loop_swaps": loop.aux["swaps"],
           "n_traces": {"loop": loop.aux["n_traces"], "scan": scan.aux["n_traces"]},
           "bitwise_equal": bitwise, "loss_max_abs_diff": max_diff,
           "acc_mean": _final(scan)["acc_mean"],
           "seconds": {r: v["seconds"] for r, v in runs.items()},
           "refreshes": runs["scan"]["refreshes"]}
    note(f"# 6b inline: swaps scan {out['swaps']} loop {out['loop_swaps']}, captures "
          f"{out['n_traces']}, graph == loop bitwise: {bitwise} (max |loss diff| {max_diff:.3e}), "
          f"acc_mean {out['acc_mean']:.4f}")
    check(out["swaps"] == out["loop_swaps"] and len(out["swaps"]) >= 1,
          "6b: the rollouts swapped at different steps, or never")
    check(scan.aux["n_traces"] == 1, f"6b: {scan.aux['n_traces']} captures, expected 1")
    check(bitwise or np.allclose(l_scan, l_loop, rtol=1e-6, atol=0.0),
          f"6b: graph and loop losses differ by {max_diff:.3e} (bound 1e-6 relative)")
    check(bool(np.isfinite(l_scan).all()) and l_scan[-10:].mean() < l_scan[:10].mean(),
          "6b: the captured run's loss did not fall")

    # overlap mode: the solve runs on a worker while the graph replays
    ctl = _online_controller(Pi0, res0, overlap=True)
    try:
        log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                    schedule=ctl.schedule_arrays(),
                                    on_segment=_feed(ctl, labels), rollout="scan", **kw)
        in_run = list(ctl.refresh_log)
        ctl.request_refresh("final flush")
        ctl.on_segment(steps - 1)
        final = ctl.flush(steps)
    finally:
        ctl.close()
    check(counts["gossip_schedule"] == steps, f"6b overlap: launches {counts}")
    launches["gossip_schedule"] += counts["gossip_schedule"]
    check(all(r["blocked_s"] == 0.0 and "error" not in r for r in in_run),
          f"6b overlap: a swap was not collected free: {in_run}")
    check(final is not None and ctl.refresh_log[-1]["t_collect"] == steps,
          "6b overlap: the final flush was not recorded")
    out["overlap"] = {
        "swaps": log.aux["swaps"], "n_traces": log.aux["n_traces"], "seconds": secs,
        "submitted": sum(1 for e in ctl.events if e.get("submitted")),
        "in_run": [{k: r[k] for k in ("t_submit", "t_collect", "solve_s", "pending_segments",
                                      "blocked_s")} for r in in_run],
        "final_flush": {k: ctl.refresh_log[-1][k] for k in ("t_submit", "t_collect", "solve_s",
                                                             "blocked_s")}}
    note("# 6b overlap " + json.dumps(out["overlap"]))
    check(log.aux["n_traces"] == 1, "6b overlap: captures grew")
    return out


def graph_step_times(data, steps: int = 256, every: int = 32) -> dict:
    """Phase 6b, printed and not checked: steady ms per step of phase 2b's
    schedule and dense arms, loop against graph, from the ``sim.segment``
    spans of a run evaluated every ``every`` steps on a 1000-sample test
    set (the evaluation runs outside the spans). Segments 3 on are timed:
    in the graph the first ``every``-step segment is the eager warm-up and
    the second captures, so the rest are replays. (The difference of two
    whole runs, as phase 2e takes, is dominated here by the run-to-run
    spread of the data setup.) The device busy share is the profiler's
    device time per step, in a run without evaluation, over that ms per
    step."""
    X, y, idx, Pi = data
    n_train = sum(len(i) for i in idx)
    res = learn_topology(Pi, budget=10, lam=0.1)
    arms = {"schedule": (None, schedule_from_result(res)), "dense": (res.W, None)}
    kw = dict(model="mlp", hidden=64, batch_size=64, lr=0.2, seed=0, device="cuda",
              steps=steps, eval_every=every, X_test=X[n_train:n_train + 1000],
              y_test=y[n_train:n_train + 1000])
    out = {}
    for arm, (W, sched) in arms.items():
        for rollout in ("loop", "scan"):
            tracer = Tracer()
            run_classification(X[:n_train], y[:n_train], idx, W, schedule=sched,
                               rollout=rollout, tracer=tracer, **kw)
            segs = [sp.duration_s for sp in tracer.spans("sim.segment")
                    if sp.attrs["k"] == every]
            ms = 1e3 * float(np.median(segs[2:])) / every
            # the device time of the steps alone: the same run without evaluation
            per_kernel, n_ops = device_profile(run_classification, X[:n_train], y[:n_train],
                                               idx, W, schedule=sched, rollout=rollout,
                                               **{**kw, "X_test": None, "y_test": None})
            dev = sum(v for k, v in per_kernel.items() if "HtoD" not in k) / steps
            out[f"{arm} {rollout}"] = {
                "ms_per_step": ms, "device_ms_per_step": dev, "device_busy_share": dev / ms,
                "device_ops_per_step": n_ops / steps,
                "segment_ms": [1e3 * t for t in segs],  # warm-up, capture (graph), steady
            }
    return out


def phase_warm_refresh() -> dict:
    """Phase 6c: a cold solve and a warm refresh at n = 512, budget 64 (the
    reference's ``bench_online`` claim 1), with the scipy LMO and with the
    device auction: equal cold objectives, the device LMO's warm refresh
    reaching the scipy refresh's objective; seconds and FW iterations of
    each, printed. Returns the auction's launches."""
    n, K, budget = 512, 64, 64
    rng = np.random.default_rng(0)
    Pi0 = rng.dirichlet(0.1 * np.ones(K), size=n)
    res0 = learn_topology(Pi0, budget=budget, lam=0.1)
    Pi1 = Pi0[rng.permutation(n)]
    out, launches = {}, 0
    for lmo in ("scipy", "auction_jit"):
        cold, counts_cold, cold_s = counted(learn_topology, Pi1, budget=budget, lam=0.1, lmo=lmo)
        ref = TopologyRefresher(res0, RefreshConfig(budget=budget // 4, lam=0.1), lmo=lmo,
                                device="cuda")
        warm, counts_warm, _ = counted(ref.refresh, Pi1)
        launches += counts_cold["auction"] + counts_warm["auction"]
        out[lmo] = {"cold_s": cold_s, "cold_iters": len(cold.gamma_trace),
                    "warm_s": ref.last_refresh_s, "warm_iters": ref.last_iters,
                    "objective_cold": float(cold.objective_trace[-1]),
                    "objective_warm": float(warm.objective_trace[-1]),
                    "lmo_solves": len(cold.gap_trace) + len(warm.gap_trace),
                    "auction_launches": counts_cold["auction"] + counts_warm["auction"]}
    note("# 6c " + json.dumps(out))
    s_, j_ = out["scipy"], out["auction_jit"]
    check(abs(j_["objective_cold"] - s_["objective_cold"]) <= 1e-9 * max(1.0, s_["objective_cold"]),
          "6c: the device LMO's cold objective is not scipy's")
    check(j_["objective_warm"] <= s_["objective_warm"] + 1e-9 * max(1.0, s_["objective_warm"]),
          "6c: the device LMO's warm refresh does not reach the scipy refresh's objective")
    check(j_["auction_launches"] == j_["lmo_solves"] and s_["auction_launches"] == 0,
          f"6c: {j_['auction_launches']} auction launches for {j_['lmo_solves']} LMO solves")
    return launches


def phase_online_device_lmo(data, launches: dict, steps: int = 200) -> int:
    """Phase 6c (continued): phase 6b's controller with ``lmo="auction_jit"``
    (its LMO on the card, its prices kept there across refreshes), inline
    and in overlap mode -- the worker's solves next to the trainer's
    captures -- in the captured rollout: one capture per arm, every swap
    collected, no failed refresh. Returns the auction's launches."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    out, auction = {}, 0
    for overlap in (False, True):
        ctl = _online_controller(Pi0, res0, lmo="auction_jit", overlap=overlap)
        try:
            log, counts, secs = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                        schedule=ctl.schedule_arrays(),
                                        on_segment=_feed(ctl, labels), rollout="scan", **kw)
            final = ctl.flush(steps) if ctl.refresh_pending else None
        finally:
            ctl.close()
        arm = "overlap" if overlap else "inline"
        check(counts["gossip_schedule"] == steps, f"6c {arm} auction_jit: launches {counts}")
        launches["gossip_schedule"] += counts["gossip_schedule"]
        auction += counts["auction"]
        check(log.aux["n_traces"] == 1, f"6c {arm} auction_jit: {log.aux['n_traces']} captures")
        # inline a refresh swaps at its boundary; in overlap mode it lands
        # at the first boundary after the solve, or at the final flush
        in_run = [r for r in ctl.refresh_log if r["t_collect"] < steps]
        check(ctl.failed_refreshes == 0 and counts["auction"] >= 1
              and len(log.aux["swaps"]) == len(in_run) and (in_run or final is not None)
              and all(r["blocked_s"] == 0.0 for r in in_run),
              f"6c {arm} auction_jit: refreshes {ctl.refresh_log}, swaps {log.aux['swaps']}")
        out[arm] = {"swaps": log.aux["swaps"], "n_traces": log.aux["n_traces"],
                    "refreshes": ctl.refresher.n_refreshes, "auction_launches": counts["auction"],
                    "seconds": secs, "acc_mean": _final(log)["acc_mean"],
                    "refresh_log": [{k: r[k] for k in ("t_submit", "t_collect", "solve_s",
                                                       "pending_segments", "blocked_s")}
                                    for r in ctl.refresh_log]}
    note("# 6c online auction_jit " + json.dumps(out))
    return auction


def check_table_pick(pick: str, timing: dict) -> None:
    """Phase 2b's learned topology (n 100, 10 communication atoms, P
    50890) runs under the graph as a schedule arm and a dense arm: the
    transport phase 2d's table picks for that bucket must not be slower
    end to end than the other beyond the arms' run-to-run noise."""
    ms = {arm: timing[f"{arm} scan"]["ms_per_step"] for arm in ("schedule", "dense")}
    other = "dense" if pick == "schedule" else "schedule"
    note(f"# 6b table pick at phase 2b's bucket: {pick} ({ms[pick]:.4f} ms/step under the "
         f"graph), {other} {ms[other]:.4f}")
    check(ms[pick] <= END_TO_END_NOISE * ms[other],
          f"6b: the table picks {pick} at phase 2b's bucket, {ms[pick]:.4f} ms/step against "
          f"{other}'s {ms[other]:.4f}")


def phase_online(mnist, table_pick: str) -> dict:
    """Phase 6; returns the gossip kernels' launches over its counted runs."""
    launches = {"gossip_schedule": 0, "gossip_mix": 0, "auction": 0}
    phase_capture_kernels()
    phase_drift_recovery(launches)
    phase_online_full_width(mnist, launches)
    timing = graph_step_times(mnist)
    for label, r in timing.items():
        note(f"# 6b timing {label} " + json.dumps(r))
    check_table_pick(table_pick, timing)
    launches["auction"] += phase_warm_refresh()
    launches["auction"] += phase_online_device_lmo(mnist, launches)
    note(f"# 6 launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the robustness layer inside the captured rollout
# ---------------------------------------------------------------------------

def _span_ms(tracer, k: int) -> float:
    """Steady ms per step from the ``sim.segment`` spans of ``k``-step
    segments: the first is the eager warm-up and the second captures, so
    the rest are replays."""
    segs = [sp.duration_s for sp in tracer.spans("sim.segment") if sp.attrs["k"] == k]
    return 1e3 * float(np.median(segs[2:])) / k


def _expect_schedule(label: str, counts: dict, want: int, launches: dict) -> None:
    check(counts["gossip_schedule"] == want and counts["gossip_mix"] == 0,
          f"{label}: launches {counts}, expected gossip_schedule={want}")
    launches["gossip_schedule"] += counts["gossip_schedule"]


def _robust_setup(data, steps: int):
    """Phase 2b's shape on the data plane: n = 100, the MLP (P = 50890),
    STL-FW budget 10 at l_max 11, and a second schedule (the topology of
    the label-swapped fleet) the hook swaps in at ``steps // 2 - 1``."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    perm = np.random.default_rng(11).permutation(n)
    sa = schedule_to_arrays(schedule_from_result(learn_topology(Pi0, budget=10, lam=0.1)),
                            l_max=11, device="cuda")
    sa2 = schedule_to_arrays(schedule_from_result(learn_topology(Pi0[perm], budget=10, lam=0.1)),
                             l_max=11, device="cuda")
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:n_train + 1000], y_test=y[n_train:n_train + 1000], seed=0,
              device="cuda", schedule=sa)
    return (X[:n_train], y[:n_train], idx, None), kw, (lambda t: sa2 if t == steps // 2 - 1
                                                        else None)


def phase_probes(data, launches: dict, steps: int = 200, timed: int = 256) -> dict:
    """7a: phase 6b's online run with health probes (consensus, grad_dev,
    tau_bar at the controller's live Pi_hat): losses bitwise the probes-off
    run, one capture each; then the per-step probe cost from the
    ``sim.segment`` spans of ``timed``-step runs."""
    X, y, idx, Pi0 = data
    n, n_train = len(idx), sum(len(i) for i in idx)
    res0 = learn_topology(Pi0, budget=10, lam=0.1)
    labels = labels_stream(
        AbruptLabelSwap(Pi0, t_drift=steps // 2,
                        node_perm=np.random.default_rng(11).permutation(n)),
        steps, 64, seed=0)
    kw = dict(model="mlp", hidden=64, steps=steps, batch_size=64, lr=0.2, eval_every=20,
              X_test=X[n_train:], y_test=y[n_train:], seed=0, device="cuda")
    logs = {}
    for arm, probes in (("off", None), ("on", HealthProbes(tau_bar=True))):
        ctl = _online_controller(Pi0, res0)
        extra = dict(probes=probes, pi_hat=Pi0) if probes is not None else {}
        log, counts, _ = counted(run_classification, X[:n_train], y[:n_train], idx, None,
                                 schedule=ctl.schedule_arrays(), on_segment=_feed(ctl, labels),
                                 rollout="scan", **extra, **kw)
        # the tau_bar probe mixes pi_hat through gossip_schedule: one more a step
        _expect_schedule(f"7a probes {arm}", counts, steps * (2 if probes else 1), launches)
        logs[arm] = log
    on, off = logs["on"], logs["off"]
    bitwise = bool(np.array_equal(on.column("loss"), off.column("loss"))) and \
        on.history == off.history
    health = on.aux["health"]
    out = {"bitwise_equal": bitwise, "swaps": on.aux["swaps"],
           "n_traces": {"off": off.aux["n_traces"], "on": on.aux["n_traces"]},
           "health_last": {k: float(v[-1]) for k, v in health.items()}}
    check(bitwise, "7a: the probes-on run is not bitwise the probes-off run")
    check(on.aux["swaps"] == off.aux["swaps"] and len(on.aux["swaps"]) >= 1,
          f"7a: swaps {on.aux['swaps']} / {off.aux['swaps']}")
    check(out["n_traces"] == {"off": 1, "on": 1}, f"7a: captures {out['n_traces']}")
    check(all(np.isfinite(v).all() and v.shape == (steps,) for v in health.values()),
          "7a: non-finite or missing probe values")
    # the cost: timed-step runs evaluated every 32 steps (outside the spans)
    sa = schedule_to_arrays(schedule_from_result(res0), l_max=11, device="cuda")
    tkw = {**kw, "steps": timed, "eval_every": 32, "X_test": X[n_train:n_train + 1000],
           "y_test": y[n_train:n_train + 1000]}
    ms = {}
    for arm, extra in (("off", {}), ("default", dict(probes=HealthProbes())),
                       ("tau_bar", dict(probes=HealthProbes(tau_bar=True), pi_hat=Pi0))):
        tracer = Tracer()
        run_classification(X[:n_train], y[:n_train], idx, None, schedule=sa, rollout="scan",
                           tracer=tracer, **extra, **tkw)
        ms[arm] = _span_ms(tracer, 32)
    out["ms_per_step"] = ms
    out["probe_ms_per_step"] = {arm: ms[arm] - ms["off"] for arm in ("default", "tau_bar")}
    note("# 7a probes " + json.dumps(out))
    return out


def phase_compression(data, launches: dict, steps: int = 200) -> dict:
    """7b: phase 2b's shape on the schedule transport with a swap, under
    the wires none, identity, bf16 and topk:0.1:g0.25: identity bitwise
    none (losses and bytes), bf16 0.5x the bytes, top-k k * 8 a node,
    graph bitwise the loop for bf16 and top-k, one capture an arm;
    printed: ms per step of each wire."""
    args, kw, hook = _robust_setup(data, steps)
    n = len(args[2])
    P = 784 * 64 + 64 + 64 * 10 + 10
    runs = {}
    for wire in (None, "identity", "bf16", "topk:0.1:g0.25"):
        rollouts = ("scan", "loop") if wire in ("bf16", "topk:0.1:g0.25") else ("scan",)
        for rollout in rollouts:
            tracer = Tracer()
            log, counts, secs = counted(run_classification, *args, on_segment=hook,
                                        compression=wire, rollout=rollout, tracer=tracer, **kw)
            _expect_schedule(f"7b {wire} {rollout}", counts, steps, launches)
            runs[wire, rollout] = {"log": log, "ms": _span_ms(tracer, 20), "seconds": secs}
    none, ident = runs[None, "scan"]["log"], runs["identity", "scan"]["log"]
    f32_bytes = none.aux["comm"]["per_step_bytes"]
    out = {"ms_per_step": {str(w): r["ms"] for (w, ro), r in runs.items() if ro == "scan"},
           "loop_ms_per_step": {str(w): r["ms"] for (w, ro), r in runs.items() if ro == "loop"},
           "per_step_bytes": {str(w): r["log"].aux["comm"]["per_step_bytes"]
                              for (w, ro), r in runs.items() if ro == "scan"},
           "n_traces": {str(w): r["log"].aux["n_traces"] for (w, ro), r in runs.items()
                        if ro == "scan"},
           "final_loss": {str(w): float(r["log"].column("loss")[-10:].mean())
                          for (w, ro), r in runs.items() if ro == "scan"}}
    check(none.history == ident.history and none.aux["comm"] == ident.aux["comm"],
          "7b: the identity wire is not bitwise the uncompressed run")
    check(2 * runs["bf16", "scan"]["log"].aux["comm"]["per_step_bytes"] == f32_bytes,
          "7b: the bf16 wire does not move exactly half the bytes")
    k = max(1, int(P * 0.1))
    check(runs["topk:0.1:g0.25", "scan"]["log"].aux["comm"]["per_step_bytes"] == (n - 1) * k * 8,
          "7b: the top-k wire does not cost k * 8 bytes a node")
    for wire in ("bf16", "topk:0.1:g0.25"):
        scan, loop = runs[wire, "scan"]["log"], runs[wire, "loop"]["log"]
        check(scan.history == loop.history, f"7b {wire}: graph and loop differ")
    check(all(v == 1 for v in out["n_traces"].values()), f"7b: captures {out['n_traces']}")
    check(all(np.isfinite(v) for v in out["final_loss"].values()), "7b: non-finite loss")
    note("# 7b compression " + json.dumps(out))
    return out


def phase_staleness(data, launches: dict, steps: int = 200) -> dict:
    """7c: phase 2b's shape under bounded-delay gossip: a zero-delay arm
    bitwise the fresh run (losses and bytes), ``wait`` and ``degrade`` at
    tau_max 4 on a FaultPlan's straggler trace (rate 0.3, tau_max 4, plus
    1% hard stragglers past the deadline), and wait with the bf16 wire;
    one capture an arm; printed: ms per step and the ring's bytes."""
    from repro_torch.faults import FaultPlan

    args, kw, hook = _robust_setup(data, steps)
    n = len(args[2])
    plan = FaultPlan(n_nodes=n, steps=steps, seed=8, straggler_rate=0.3, tau_max=4)
    plan.delays[np.random.default_rng([8, 99]).random((steps, n)) < 0.01] = 6
    arms = {"fresh": {}, "zero": dict(staleness=StragglerPolicy("wait", 4)),
            "wait": dict(staleness=StragglerPolicy("wait", 4), delays=plan.delays),
            "degrade": dict(staleness=StragglerPolicy("degrade", 4), delays=plan.delays),
            "wait+bf16": dict(staleness=StragglerPolicy("wait", 4), delays=plan.delays,
                              compression="bf16")}
    runs = {}
    for arm, extra in arms.items():
        tracer = Tracer()
        log, counts, _ = counted(run_classification, *args, on_segment=hook, rollout="scan",
                                 tracer=tracer, **extra, **kw)
        _expect_schedule(f"7c {arm}", counts, steps, launches)
        runs[arm] = {"log": log, "ms": _span_ms(tracer, 20)}
    fresh, zero = runs["fresh"]["log"], runs["zero"]["log"]
    P_pad = -(-(784 * 64 + 64 + 64 * 10 + 10) // 8) * 8
    out = {"ms_per_step": {a: r["ms"] for a, r in runs.items()},
           "n_traces": {a: r["log"].aux["n_traces"] for a, r in runs.items()},
           "comm": {a: r["log"].aux["comm"] for a, r in runs.items() if a != "fresh"},
           "final_loss": {a: float(r["log"].column("loss")[-10:].mean())
                          for a, r in runs.items()},
           "ring_bytes": 5 * n * P_pad * 4}
    check(zero.history == fresh.history, "7c: zero delays are not bitwise the fresh run")
    check(zero.aux["comm"]["total_bytes"] == fresh.aux["comm"]["total_bytes"]
          and zero.aux["comm"]["deferred_bytes"] == 0, "7c: zero-delay bytes differ")
    check(all(v == 1 for v in out["n_traces"].values()), f"7c: captures {out['n_traces']}")
    check(all(np.isfinite(v) for v in out["final_loss"].values()), "7c: non-finite loss")
    note("# 7c staleness " + json.dumps(out))
    return out


def _faulty(label: str, launches: dict, task, plan, arrays, **kw) -> dict:
    out, counts, _ = counted(run_faulty_mean_estimation, task, plan, arrays, device="cuda", **kw)
    _expect_schedule(f"7d {label}", counts,
                     plan.steps - (out["resumed_from"] or 0) if out["stopped_at"] is None
                     else out["stopped_at"], launches)
    check(out["n_traces"] == 1, f"7d {label}: {out['n_traces']} captures")
    return out


def phase_faults(launches: dict, smoke: bool = False) -> dict:
    """7d: ``run_faulty_mean_estimation`` at ``benchmarks/bench_faults.py``'s
    non-smoke sizes: a fault-sweep cell, the straggler bars, the
    corruption bar, the crash-recovery drill; one capture an arm."""
    from repro_torch.data.drift import NodeChurn
    from repro_torch.faults import FaultPlan, QuarantineController, ScreenPolicy

    lam, out = 0.1, {}

    def setup(n, K, steps, zs_seed, batch=2):
        task = mean_estimation_clusters(n_nodes=n, K=K, m=5.0, sigma_tilde2=1.0)
        res0 = learn_topology(task.Pi, budget=8, lam=lam)
        sched0 = schedule_from_result(res0)
        arrays = schedule_to_arrays(sched0, sched0.n_atoms + 2, device="cuda")
        rng = np.random.default_rng(zs_seed)
        zs = np.stack([task.sample(batch, rng) for _ in range(steps)]).astype(np.float32)
        return task, res0, arrays, zs

    # a fault-sweep cell: crash 0.05, stragglers at tau 4, 15% edge drops
    n, K, steps, seg = (8, 4, 120, 20) if smoke else (32, 8, 600, 50)
    task, _, arrays, zs = setup(n, K, steps, 1)
    tail = slice(-max(10, steps // 10), None)
    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    base = _faulty("sweep base", launches, task, FaultPlan(n_nodes=n, steps=steps, seed=0),
                   arrays, **kw)
    cell = _faulty("sweep cell", launches, task,
                   FaultPlan(n_nodes=n, steps=steps, seed=3, crash_rate=0.05, mean_outage=6.0,
                             straggler_rate=0.3, tau_max=4, edge_drop_rate=0.15), arrays, **kw)
    base_err = float(np.median(base["mean_sq_error"][tail]))
    out["sweep_cell"] = {"gap_ratio": float(np.median(cell["mean_sq_error"][tail])) / base_err,
                         "alive_frac": cell["alive_frac"], "comm": cell["comm"]}
    check(np.isfinite(cell["mean_sq_error"]).all(), "7d sweep cell: non-finite error")

    # the straggler bars: tau_max <= 4, <= 25% stragglers -> wait within
    # 10% of fault-free, degrade within 20%
    task, _, arrays, zs = setup(n, K, steps, 6)
    tail = slice(-max(10, steps // 3), None)
    kw = dict(lr=0.02, seed=2, zs=zs, segment_len=seg)
    plan0 = FaultPlan(n_nodes=n, steps=steps, seed=0)
    base = _faulty("straggler base", launches, task, plan0, arrays, **kw)
    base_err = float(np.median(base["mean_sq_error"][tail]))
    for mode in ("wait", "degrade"):  # the delays=0 control arms
        ctrl = _faulty(f"delays=0 {mode}", launches, task, plan0, arrays,
                       staleness=StragglerPolicy(mode, 4), **kw)
        check(np.array_equal(ctrl["mean_sq_error"], base["mean_sq_error"])
              and ctrl["comm"]["total_bytes"] == base["comm"]["total_bytes"],
              f"7d: the delays=0 {mode} arm is not bitwise the fresh run")
    hard = 0.02 if smoke else 0.01
    ratios = {}
    for tau in (2, 4):
        for rate in (0.1, 0.25):
            plan = FaultPlan(n_nodes=n, steps=steps, seed=8, straggler_rate=rate, tau_max=tau)
            late = np.random.default_rng([8, 99, tau, int(rate * 100)]).random((steps, n)) < hard
            plan.delays[late] = tau + 2
            for mode in ("wait", "degrade"):
                r = _faulty(f"straggler {mode} tau={tau} rate={rate}", launches, task, plan,
                            arrays, staleness=StragglerPolicy(mode, tau), **kw)
                ratio = float(np.median(r["mean_sq_error"][tail])) / base_err
                ratios[f"{mode} tau={tau} rate={rate}"] = ratio
                bar = 1.10 if mode == "wait" else 1.20
                check(ratio <= bar, f"7d straggler {mode} tau={tau} rate={rate}: "
                                    f"{ratio:.3f} > {bar}")
    out["straggler_ratios"] = ratios

    # corruption at 10% lying nodes, every mode: screen on within 1.2x of
    # the oracle (the liars offline from t_start), corruption-off bitwise
    n, K, steps, seg = (8, 4, 120, 20) if smoke else (16, 4, 300, 30)
    task, _, arrays, zs = setup(n, K, steps, 12)
    tail = slice(-max(10, steps // 10), None)
    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    policy = ScreenPolicy(confirm_streak=2, cooldown_steps=2 * steps, probation_steps=8)
    plan0 = FaultPlan(n_nodes=n, steps=steps, seed=0)
    plain = _faulty("corruption plain", launches, task, plan0, arrays, **kw)
    q0 = QuarantineController(n, policy, lr=0.05)
    clean = _faulty("corruption clean screen", launches, task, plan0, arrays, quarantine=q0,
                    **kw)
    check(np.array_equal(clean["mean_sq_error"], plain["mean_sq_error"])
          and q0.n_quarantines == 0, "7d: the clean screened run is not bitwise the plain one")
    h, t_start = max(1, round(0.1 * n)), 5
    liars, honest = list(range(h)), list(range(h, n))
    oracle_plan = FaultPlan(n_nodes=n, steps=steps, seed=0)
    oracle_plan.alive[t_start:, liars] = False
    oracle = _faulty("corruption oracle", launches, task, oracle_plan, arrays,
                     quarantine=QuarantineController(n, policy, lr=0.05), **kw)

    def honest_tail(r):
        return float(np.median(np.mean(r["sq_error_nodes"][:, honest], axis=1)[tail]))

    corrupt = {}
    for mode, (mult, xor) in {"nan": (np.nan, 0), "sign_flip": (-1.0, 0), "scale:8": (8.0, 0),
                              "bitflip": (1.0, 1 << 25)}.items():
        plan = FaultPlan(n_nodes=n, steps=steps, seed=0)
        plan.corrupt_mult[t_start:, liars] = mult
        plan.corrupt_xor[t_start:, liars] = xor
        q = QuarantineController(n, policy, lr=0.05)
        on = _faulty(f"corruption {mode} screen on", launches, task, plan, arrays, quarantine=q,
                     **kw)
        ratio = honest_tail(on) / honest_tail(oracle)
        corrupt[mode] = {"ratio": ratio, "n_quarantines": q.n_quarantines}
        check(ratio <= 1.2, f"7d corruption {mode}: honest tail {ratio:.3f}x > 1.2x")
    out["corruption"] = corrupt

    # the crash-recovery drill: n = 8, a crash and rejoin of node 3, one
    # warm refresh under the faults, killed at a boundary and resumed
    n, K, steps, seg = 8, 4, 120, 20
    task, res0, _, zs = setup(n, K, steps, 4)
    plan = FaultPlan.from_node_churn(NodeChurn(Pi0=task.Pi, events=((30, 3, 25),), seed=0),
                                     steps=steps, seed=5, straggler_rate=0.3, tau_max=2,
                                     edge_drop_rate=0.05)

    def drill():
        ref = TopologyRefresher(res0, RefreshConfig(budget=4, lam=lam), device="cuda")
        done = {"swapped": False}

        def hook(t):
            if not done["swapped"] and t >= 39:
                done["swapped"] = True
                ref.refresh(task.Pi)
                return ref.schedule_arrays()
            return None

        return ref.schedule_arrays(), hook

    kw = dict(lr=0.05, seed=2, zs=zs, segment_len=seg)
    arrays, hook = drill()
    full = _faulty("recovery full", launches, task, plan, arrays, on_segment=hook, **kw)
    with tempfile.TemporaryDirectory(prefix="faults_recovery_") as ckpt:
        arrays, hook = drill()
        head = _faulty("recovery head", launches, task, plan, arrays, on_segment=hook,
                       checkpoint_dir=ckpt, stop_after_segments=3, **kw)
        tail_run = _faulty("recovery tail", launches, task, plan, arrays, checkpoint_dir=ckpt,
                           resume=True, **kw)
    glued = np.concatenate([head["mean_sq_error"], tail_run["mean_sq_error"]])
    bitwise = bool(np.array_equal(glued, full["mean_sq_error"])) and \
        bool(np.array_equal(tail_run["theta"], full["theta"]))
    out["recovery"] = {"swaps": full["swaps"], "stopped_at": head["stopped_at"],
                       "resumed_from": tail_run["resumed_from"], "bitwise": bitwise}
    check(full["swaps"] == [39] and head["stopped_at"] == 60 and
          tail_run["resumed_from"] == 60, f"7d recovery: {out['recovery']}")
    check(bitwise, "7d: the resumed run is not bitwise the uninterrupted run")
    note("# 7d faults " + json.dumps(out))
    return out


def phase_robustness(mnist) -> dict:
    """Phase 7; returns the gossip kernels' launches over its counted runs."""
    launches = {"gossip_schedule": 0, "gossip_mix": 0}
    t0 = time.perf_counter()
    phase_probes(mnist, launches)
    phase_compression(mnist, launches)
    phase_staleness(mnist, launches)
    phase_faults(launches)
    note(f"# 7 launches {launches}, {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phases 3-5: the LM slice (recurrentgemma-2b) through the user's entry points
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, RG-LRU layers) of ``cfg``."""
    kinds = [cfg.kind(i) for i in range(cfg.num_layers)]
    return sum(k in ("attn", "local_attn") for k in kinds), kinds.count("rglru")


def expect_lm(label: str, counts: dict, flash: int, scan: int, device: torch.device) -> None:
    """The LM kernels' launches of one counted run (none on the CPU)."""
    if device.type != "cuda":
        flash = scan = 0
    want = {"gossip_schedule": 0, "gossip_mix": 0, "flash_attention": flash, "rglru_scan": scan,
            "auction": 0}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    note(f"# {label}: launches flash_attention={flash} rglru_scan={scan}")


def _median_s(fn, *args, repeats: int = 3, **kwargs) -> float:
    return float(np.median([counted(fn, *args, **kwargs)[2] for _ in range(repeats)]))


def device_profile(fn, *args, **kwargs) -> tuple[dict, int]:
    """Device ms of one ``fn(...)`` by kernel (and copy) from
    ``torch.profiler``, and the number of device operations it ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        counted(fn, *args, **kwargs)
    per_kernel: dict[str, float] = {}
    n_ops = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
            n_ops += e.count
    return per_kernel, n_ops


def kernel_ms(per_kernel: dict, name: str) -> float:
    """Device ms of a ``device_profile`` in kernels whose name holds ``name``."""
    return sum(v for k, v in per_kernel.items() if name in k)


def top_kernels(per_kernel: dict) -> dict:
    """The ten largest entries of a ``device_profile``, in ms."""
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {k[:90]: round(v, 3) for k, v in top}


def phase_scoring(cfg, B: int, S: int, device: torch.device,
                  label: str = "3") -> tuple[dict, object]:
    """Phase 3 (and 8): ``loss_fn`` / ``model_forward`` with the kernels at
    full width; ``label`` heads the result lines and checks."""
    n_attn, n_rglru = layer_counts(cfg)
    model = registry.init_model(cfg, seed=0, device=device)
    batch = registry.make_inputs(cfg, B, S, seed=0, device=device)
    out: dict = {"params": sum(p.numel() for p in model.parameters())}
    with torch.inference_mode():
        (loss, _), counts, out["loss_s"] = counted(registry.loss_fn, model, cfg, batch,
                                                   impl="kernel")
        expect_lm(f"{label} loss_fn kernel path", counts, n_attn, n_rglru, device)
        launches = counts
        torch.cuda.reset_peak_memory_stats()
        (logits, _, _), counts, out["forward_s"] = counted(
            registry.model_forward, model, cfg, batch, impl="kernel")
        out["forward_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        expect_lm(f"{label} model_forward kernel path", counts, n_attn, n_rglru, device)
        launches = {k: launches[k] + counts[k] for k in launches}
        check(tuple(logits.shape) == (B, S, cfg.vocab_size), f"{label}: logits shape")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        # the loss recomputed from the forward's logits, one row at a time in
        # float64, and the logit of each position's own input token: with the
        # tied, sqrt(d)-scaled embedding it dominates at random init
        nll, own = [], []
        for b in range(B):
            lf = logits[b].double()
            nll.append(torch.logsumexp(lf, -1) - lf.gather(-1, batch["labels"][b, :, None])[:, 0])
            own.append(lf.gather(-1, batch["tokens"][b, :, None])[:, 0])
        del logits, lf
        plain_loss, _ = registry.loss_fn(model, cfg, batch, impl="plain")
        out["loss"], out["plain_loss"] = float(loss), float(plain_loss)
        out["loss_from_logits"] = float(torch.cat(nll).mean())
        out["own_token_logit_mean"] = float(torch.cat(own).mean())
        out["ln_vocab"] = math.log(cfg.vocab_size)
        note(f"# {label} loss {out['loss']:.5f} (plain {out['plain_loss']:.5f}, from the forward's "
              f"logits {out['loss_from_logits']:.5f}), ln(vocab) {out['ln_vocab']:.5f}, mean "
              f"logit of the input token {out['own_token_logit_mean']:.3f}")
        check(math.isfinite(out["loss"]), f"{label}: non-finite loss")
        check(out["loss"] >= out["ln_vocab"] - 1.0,
              f"{label}: loss below ln(vocab) - 1 on random labels")
        check(abs(out["loss"] - out["loss_from_logits"]) <= 1e-2,
              f"{label}: loss_fn and the forward's logits give losses more than 1e-2 apart")
        check(abs(out["loss"] - out["plain_loss"]) <= 1e-2,
              f"{label}: kernel and plain losses differ by more than 1e-2")
        fwd = _median_s(registry.model_forward, model, cfg, batch, impl="kernel")
        out["forward_steady_s"] = fwd
        out["tokens_per_s"] = B * S / fwd
        out["plain_forward_steady_s"] = _median_s(registry.model_forward, model, cfg, batch,
                                                  impl="plain")
        per_kernel, out["device_ops"] = device_profile(
            registry.model_forward, model, cfg, batch, impl="kernel")
        out["device_ms"] = sum(per_kernel.values())
        out["top_kernels_ms"] = top_kernels(per_kernel)
        out["rglru_scan_device_ms"] = kernel_ms(per_kernel, "rglru_scan_kernel")
        out["flash_attention_device_ms"] = kernel_ms(per_kernel, "flash_fwd")
        out["device_busy_share"] = out["device_ms"] / (1e3 * fwd)
    return {"scoring": out, "launches": launches}, model


def phase_f32_depth3(cfg_full, B: int, S: int, device: torch.device,
                     label: str = "3b") -> tuple[dict, object]:
    """Phase 3b (and 8): the same forward in float32 at depth 3 (for
    recurrentgemma-2b rglru, rglru, local_attn), kernel path against plain
    path at 1e-4."""
    cfg = dataclasses.replace(cfg_full, num_layers=3, dtype="float32")
    n_attn, n_rglru = layer_counts(cfg)
    model = registry.init_model(cfg, seed=2, device=device)
    batch = registry.make_inputs(cfg, B, S, seed=2, device=device)
    with torch.inference_mode():
        (kernel, _, _), counts, _ = counted(registry.model_forward, model, cfg, batch,
                                            impl="kernel")
        expect_lm(f"{label} f32 depth-3 forward, kernel path", counts, n_attn, n_rglru, device)
        plain, _, _ = registry.model_forward(model, cfg, batch, impl="plain")
        err = float((kernel - plain).abs().max())
        note(f"# {label} f32 depth 3: max |kernel - plain| logits {err:.3e}")
        check(torch.allclose(kernel, plain, atol=1e-4, rtol=1e-4),
              f"{label}: f32 kernel and plain logits differ by {err:.3e} (atol = rtol = 1e-4)")
        del kernel, plain
        k_loss = float(registry.loss_fn(model, cfg, batch, impl="kernel")[0])
        p_loss = float(registry.loss_fn(model, cfg, batch, impl="plain")[0])
        check(abs(k_loss - p_loss) <= 1e-4, f"{label}: f32 kernel and plain losses differ")
    return {"max_abs_err": err, "loss": k_loss, "plain_loss": p_loss}, model


def eager_generate(model, cfg, prompt: torch.Tensor, new_tokens: int):
    """The eager reference of ``generate``: ``prefill``, then a loop over
    ``decode_step``. Returns (tokens (B, new_tokens), each step's logits)."""
    B, S = prompt.shape
    with torch.inference_mode():
        logits, cache = engine.prefill(model, cfg, prompt, max_len=S + new_tokens + 1)
        toks, all_logits = [logits.argmax(-1, keepdim=True)], [logits]
        for pos in range(S, S + new_tokens - 1):
            position = torch.full((B, 1), pos, device=prompt.device)
            logits, cache = engine.decode_step(model, cfg, toks[-1], position, cache)
            toks.append(logits.argmax(-1, keepdim=True))
            all_logits.append(logits)
        return torch.cat(toks, dim=1), all_logits


def decoder_logits(dec, prompt: torch.Tensor, new_tokens: int) -> list:
    """Each step's logits of the decoder ``generate`` uses, stepped by hand."""
    dec.start(prompt)
    out = [dec.logits.clone()]
    for _ in range(new_tokens - 1):
        dec.step()
        out.append(dec.logits.clone())
    return out


def phase_serving(model, cfg, B: int, prompt_len: int, new_tokens: int,
                  device: torch.device, label: str = "4") -> dict:
    """Phase 4 (and 8): prefill and greedy ``generate`` at full width.
    ``generate`` runs its decode step as a CUDA graph (``serve.engine.
    Decoder``); the eager reference is a loop over ``decode_step``. The
    graph's tokens must be the loop's and each step's logits bitwise the
    loop's, with one capture. Decode is timed and profiled through whole
    runs less a prefill's, over their ``new_tokens - 1`` decode steps; the
    busy shares are profiler device time over unprofiled wall time."""
    _, n_rglru = layer_counts(cfg)
    prompt = registry.make_inputs(cfg, B, prompt_len, seed=1, device=device)["tokens"]
    max_len = prompt_len + new_tokens + 1
    steps = new_tokens - 1
    out: dict = {"prompt_len": prompt_len, "new_tokens": new_tokens}
    with torch.inference_mode():
        _, counts, _ = counted(engine.prefill, model, cfg, prompt, max_len=max_len)
        expect_lm(f"{label} prefill", counts, 0, n_rglru, device)
        launches = counts
        out["prefill_s"] = _median_s(engine.prefill, model, cfg, prompt, max_len=max_len)
        out["prefill_tokens_per_s"] = B * prompt_len / out["prefill_s"]
        prefill_kernels, prefill_ops = device_profile(engine.prefill, model, cfg, prompt,
                                                      max_len=max_len)
    out["prefill_device_ops"] = prefill_ops
    out["prefill_top_kernels_ms"] = top_kernels(prefill_kernels)
    out["prefill_rglru_scan_device_ms"] = kernel_ms(prefill_kernels, "rglru_scan_kernel")
    out["prefill_device_busy_share"] = sum(prefill_kernels.values()) / (1e3 * out["prefill_s"])

    (eager_toks, eager_logits), counts, _ = counted(eager_generate, model, cfg, prompt,
                                                    new_tokens)
    expect_lm(f"{label} eager decode loop (prefill + decode)", counts, 0, n_rglru, device)
    gen_kw = dict(max_new_tokens=new_tokens, device=device)
    toks, counts, _ = counted(engine.generate, model, cfg, prompt, **gen_kw)
    expect_lm(f"{label} generate (prefill + captured decode)", counts, 0, n_rglru, device)
    launches = {k: launches[k] + counts[k] for k in launches}
    dec = engine.decoder_for(model, cfg, B, max_len)
    check(dec.n_captures == 1, f"{label}: {dec.n_captures} captures of the decode step")
    check(tuple(toks.shape) == (B, new_tokens), f"{label}: generated tokens' shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label}: tokens out of range")
    check(torch.equal(toks, eager_toks), f"{label}: captured and eager greedy tokens differ")
    graph_logits = decoder_logits(dec, prompt, new_tokens)  # replays only
    differ = [i for i, (a, b) in enumerate(zip(graph_logits, eager_logits))
              if not torch.equal(a, b)]
    out["logits_bitwise_steps"] = len(graph_logits) - len(differ)
    out["logits_max_abs_diff"] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(graph_logits, eager_logits))
    check(not differ, f"{label}: captured logits differ from the eager loop's at steps "
          f"{differ} (max |diff| {out['logits_max_abs_diff']:.3e})")
    check(dec.n_captures == 1, f"{label}: the decode step was captured again")
    out["captures"] = dec.n_captures
    out["capture_ms"] = 1e3 * dec.capture_s if dec.capture_s is not None else None
    out["first_tokens"] = toks[:, :8].tolist()
    del graph_logits, eager_logits

    out["generate_s"] = _median_s(engine.generate, model, cfg, prompt, **gen_kw)
    out["eager_generate_s"] = _median_s(eager_generate, model, cfg, prompt, new_tokens)
    for arm, total in (("", out["generate_s"]), ("eager_", out["eager_generate_s"])):
        out[f"{arm}decode_ms_per_token"] = 1e3 * (total - out["prefill_s"]) / steps
    out["decode_tokens_per_s"] = B * 1e3 / out["decode_ms_per_token"]
    gen_kernels, gen_ops = device_profile(engine.generate, model, cfg, prompt, **gen_kw)
    decode_kernels = {k: v - prefill_kernels.get(k, 0.0) for k, v in gen_kernels.items()}
    out["decode_device_ops_per_token"] = (gen_ops - prefill_ops) / steps
    out["decode_device_ms_per_token"] = sum(decode_kernels.values()) / steps
    out["decode_top_kernels_ms"] = top_kernels(decode_kernels)
    # the eager loop launches the same kernels (profiled on an H100, its
    # device ms per token came within 3% of the graph's), so its busy share
    # is the graph's device time over the loop's own wall time
    for arm in ("", "eager_"):
        out[f"{arm}decode_device_busy_share"] = (out["decode_device_ms_per_token"]
                                                 / out[f"{arm}decode_ms_per_token"])
    return {"serving": out, "launches": launches}


def phase_decode_consistency(model, cfg_f32, B: int, S: int, device: torch.device,
                             label: str = "4b") -> float:
    """Phase 4b (and 8): prefill S - 3 tokens into the decoder, decode the
    last three through it (the warm-up, the capture, a replay) and compare
    each step's logits with the full forward's at the reference's 2e-3
    (tests/test_decode_consistency.py)."""
    toks = registry.make_inputs(cfg_f32, B, S, seed=3, device=device)["tokens"]
    dec = engine.Decoder(model, cfg_f32, B, S + 8)
    with torch.inference_mode():
        hidden, _, _ = model(toks, return_hidden=True)
        full = unembed(model.embed, hidden[:, -3:], cfg_f32)
        del hidden
        dec.start(toks[:, : S - 3])
        errs = []
        for i in range(3):
            dec.step(toks[:, S - 3 + i : S - 2 + i])
            errs.append(float((dec.logits - full[:, i]).abs().max()))
    err = max(errs)
    note(f"# {label} f32 depth-3 decode (through the decoder) vs full forward at positions "
         f"{S - 3}-{S - 1}: max |diff| {', '.join(f'{e:.3e}' for e in errs)}; "
         f"captures {dec.n_captures}")
    check(err < 2e-3, f"{label}: decode and full forward differ by {err:.3e} (limit 2e-3)")
    check(dec.n_captures == 1, f"{label}: {dec.n_captures} captures of the decode step")
    return err


def phase_lm_cross_device() -> float:
    """Phase 5: the smoke config's kernel path on the card against its plain
    path on the CPU (float32, num_layers = 5), within 1e-4."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), num_layers=5)
    cpu_model = registry.init_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = registry.make_inputs(cfg, 2, 256, seed=0, device="cpu")
    gpu_batch = {k: v.cuda() for k, v in batch.items()}
    with torch.inference_mode():
        gpu, _, _ = registry.model_forward(gpu_model, cfg, gpu_batch, impl="kernel")
        cpu, _, _ = registry.model_forward(cpu_model, cfg, batch, impl="plain")
        gpu_loss = float(registry.loss_fn(gpu_model, cfg, gpu_batch, impl="kernel")[0])
        cpu_loss = float(registry.loss_fn(cpu_model, cfg, batch, impl="plain")[0])
    err = float((gpu.cpu() - cpu).abs().max())
    note(f"# 5 smoke config, max |cuda kernel path - cpu plain path| {err:.3e}, losses "
          f"{gpu_loss:.6f} and {cpu_loss:.6f}")
    check(torch.allclose(gpu.cpu(), cpu, atol=1e-4, rtol=1e-4),
          f"5: cuda kernel path and cpu plain path differ by {err:.3e}")
    check(abs(gpu_loss - cpu_loss) <= 1e-4, "5: cuda and cpu losses differ")
    return err


def phase_lm(device: torch.device) -> dict:
    """Phases 3-5; returns the LM kernels' launches over the main-path runs
    (phase 3's loss and forward, phase 4's prefill and generate)."""
    cfg = get_config("recurrentgemma-2b")
    n_attn, n_rglru = layer_counts(cfg)
    check((n_attn, n_rglru) == (8, 18), f"recurrentgemma-2b has {n_attn} + {n_rglru} layers")
    scoring, model = phase_scoring(cfg, 2, 4096, device)
    note("# 3 " + json.dumps(scoring["scoring"]))
    serving = phase_serving(model, cfg, 2, 2560, 32, device)
    note("# 4 " + json.dumps(serving["serving"]))
    del model
    free_card()
    f32, model32 = phase_f32_depth3(cfg, 2, 4096, device)
    note("# 3b f32 depth 3 " + json.dumps(f32))
    phase_decode_consistency(model32, model32.cfg, 2, 2560, device)
    del model32
    free_card()
    phase_lm_cross_device()
    launches = {k: scoring["launches"][k] + serving["launches"][k]
                for k in ("flash_attention", "rglru_scan")}
    return {"launches": launches, "per_forward": {"flash_attention": n_attn,
                                                  "rglru_scan": n_rglru}}


def free_card() -> None:
    """Release a dropped model's memory (its decoder's graph and cache go
    with it) before the next one is built."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the dense GQA families at their published widths and full depth
# ---------------------------------------------------------------------------

# name -> (attention layers, serving prompt length): gemma2's prompt
# overruns its 4096 window (a multiple of 512, so the prefill takes the
# chunked attention and the ring clamp, and decode wraps the ring)
DENSE = {"qwen3-0.6b": (28, 2560), "gemma-2b": (18, 2560), "gemma2-2b": (26, 4608),
         "qwen2.5-14b": (48, 2560)}


def phase_dense(name: str, device: torch.device) -> dict:
    """Phase 8 for one family, random bf16 weights from seed 0: scoring at
    B = 2, S = 4096 (one flash_attention launch per attention layer and
    forward; the loss against the plain path and ln(vocab) - 1); f32 at
    depth 3 (kernel against plain path, decode against the full forward
    through the decoder, 2e-3); serving at B = 2 (a ``prompt_len`` prompt,
    32 new tokens), the captured decode against the eager loop."""
    t0 = time.perf_counter()
    label = f"8 {name}"
    cfg = get_config(name)
    n_want, prompt_len = DENSE[name]
    n_attn, n_rglru = layer_counts(cfg)
    check((n_attn, n_rglru) == (n_want, 0), f"{name} has {n_attn} + {n_rglru} layers")
    scoring, model = phase_scoring(cfg, 2, 4096, device, label)
    note(f"# {label} scoring " + json.dumps(scoring["scoring"]))
    t1 = time.perf_counter()
    serving = phase_serving(model, cfg, 2, prompt_len, 32, device, label)
    note(f"# {label} serving " + json.dumps(serving["serving"]))
    del model
    free_card()
    t2 = time.perf_counter()
    f32, model32 = phase_f32_depth3(cfg, 2, 4096, device, label)
    note(f"# {label} f32 depth 3 " + json.dumps(f32))
    f32["decode_max_abs_err"] = phase_decode_consistency(model32, model32.cfg, 2, prompt_len,
                                                         device, label)
    del model32
    free_card()
    seconds = {"scoring": t1 - t0, "serving": t2 - t1, "f32": time.perf_counter() - t2}
    sv = serving["serving"]
    summary = {
        "family": name, "params": scoring["scoring"]["params"],
        "flash_launches_per_forward": n_attn,
        "loss": scoring["scoring"]["loss"], "plain_loss": scoring["scoring"]["plain_loss"],
        "ln_vocab": scoring["scoring"]["ln_vocab"],
        "scoring_tokens_per_s": scoring["scoring"]["tokens_per_s"],
        "scoring_device_busy_share": scoring["scoring"]["device_busy_share"],
        "flash_attention_device_ms": scoring["scoring"]["flash_attention_device_ms"],
        "f32_depth3": f32, "prefill_tokens_per_s": sv["prefill_tokens_per_s"],
        "decode_ms_per_token": sv["decode_ms_per_token"],
        "eager_decode_ms_per_token": sv["eager_decode_ms_per_token"],
        "decode_tokens_per_s": sv["decode_tokens_per_s"],
        "decode_device_busy_share": sv["decode_device_busy_share"],
        "eager_decode_device_busy_share": sv["eager_decode_device_busy_share"],
        "decode_device_ops_per_token": sv["decode_device_ops_per_token"],
        "capture_ms": sv["capture_ms"], "seconds": time.perf_counter() - t0,
        "seconds_by_part": seconds,
    }
    note(f"# {label} " + json.dumps(summary))
    return {k: scoring["launches"][k] + serving["launches"][k]
            for k in ("flash_attention", "rglru_scan")}


def phase_dense_families(device: torch.device) -> dict:
    """Phase 8: every dense family, one at a time (qwen2.5-14b alone is
    29.6 GB of bf16 weights); returns their main-path launches."""
    launches = {"flash_attention": 0, "rglru_scan": 0}
    for name in DENSE:
        for k, v in phase_dense(name, device).items():
            launches[k] += v
    check(launches["rglru_scan"] == 0, "8: the dense families launched rglru_scan")
    return launches


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    parser.add_argument("--save-table", metavar="PATH",
                        help="also write phase 2d's measured transport table to PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"# 0 {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"kernels built in {build_s:.1f} s")

    mnist = mnist_width_data()
    rows = phase_kernels(mnist[3]) + phase_lm_kernels() + phase_auction(mnist[3])
    for r in rows:
        if r["kernel"] == "auction":
            note(f"# 1 auction {r['case']}: kernel_ms={r['kernel_ms']:.3f} "
                 f"solve_ms={r['solve_ms']:.3f} plain_ms={r['plain_ms']:.1f} (host) "
                 f"numpy_auction_ms={r['numpy_auction_ms']:.1f} scipy_ms={r['scipy_ms']:.1f} "
                 f"bound_ms={r['bound_ms']:.4f} phases={r['phases']} rounds={r['rounds']}")
        if "design" in r:  # the redesigned kernels: which design ran, and its numbers
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            note(f"# 1 {r['kernel']} {r['case']} {r['dtype']}: {r['design']}; "
                  f"kernel_ms={r['kernel_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"library_ms={lib} max_abs_err={r['max_abs_err']:.3e}")
        note("# 1 " + json.dumps(r))
    # the redesigned kernels' headlines against one library call, same run
    for name in ("gossip_schedule", "gossip_mix", "flash_attention"):
        head = next(r for r in rows if r["kernel"] == name)
        check(head["kernel_ms"] < head["library_ms"],
              f"{name} {head['case']} {head['dtype']}: {head['kernel_ms']:.4f} ms is not below "
              f"the library call's {head['library_ms']:.4f} ms")
    launches = phase_main_path(mnist)
    phase_cross_device()
    table = phase_transport_table(mnist[3], args.save_table)
    for arm, r in step_breakdown(mnist).items():
        note(f"# 2e {arm} " + json.dumps(r))
    online = phase_online(mnist, table["phase_2b_bucket"]["winner"])
    for k, v in online.items():
        launches[k] += v
    robust = phase_robustness(mnist)
    for k, v in robust.items():
        launches[k] += v
    lm = phase_lm(torch.device("cuda"))
    launches.update(lm["launches"])
    dense = phase_dense_families(torch.device("cuda"))
    launches["flash_attention"] += dense["flash_attention"]

    kernels = []
    for name, meta in KERNELS.items():
        head = next(r for r in rows if r["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head.get("shape", [head.get("n"), head.get("P")]), "dtype": head["dtype"],
        })
        if "design" in head:
            kernels[-1]["design"] = head["design"]
        if name in lm["per_forward"]:
            kernels[-1]["launches_per_forward"] = lm["per_forward"][name]
        if name in online:
            kernels[-1]["launches_phase6"] = online[name]
        if name in robust:
            kernels[-1]["launches_phase7"] = robust[name]
        if name == "flash_attention":
            kernels[-1]["launches_phase8"] = dense[name]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
