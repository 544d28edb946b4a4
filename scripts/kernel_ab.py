#!/usr/bin/env python3
"""A/B timings of kernel designs on one NVIDIA GPU, within one process.

    python3 scripts/kernel_ab.py flash OLD_CSRC
        Builds ``flash_attention.cu`` from this checkout and from OLD_CSRC
        (a directory holding another version of ``flash_attention.cu`` and
        the headers it includes, e.g. the ``csrc/`` of an older checkout
        unpacked with ``git archive`` into a gitignored directory), checks
        the new bfloat16 kernel against the plain version at small shapes
        in a child process with a time limit, then times both and
        ``scaled_dot_product_attention`` at recurrentgemma-2b's layer
        (B 2, S 4096, H 10, Hkv 1, D 256, window 2048), old and new
        alternating.
    python3 scripts/kernel_ab.py flash-bwd OLD_CSRC
        The backward kernels (``flash_attention_bwd.cu``, through
        ``ops``: both launches and the delta scratch) at the LM cell's
        layer (B 2, S 1024, H 16, Hkv 8, D 128, causal) and at
        recurrentgemma-2b's (above), beside their bound (10 D flops a
        kept pair and head at 989 TFLOP/s), the plain version's backward
        (autograd through ``flash_attention_ref`` in float32) and
        ``scaled_dot_product_attention``'s backward (bfloat16, k and v
        repeated over the group: the library's yardstick, never called by
        the port); then the forward with grad off, from this checkout
        and from OLD_CSRC alternating, and with its saved outputs.
    python3 scripts/kernel_ab.py gossip OLD_CSRC
        Builds ``gossip_mix.cu`` from this checkout and from OLD_CSRC and
        times both, and ``torch.matmul``, in float32 at the main path's
        shapes: n = 100 with P = 50890 and the four MLP leaves.
    python3 scripts/kernel_ab.py gossip-floor
        Where the 3xTF32 gossip_mix kernel's time goes at n = 100: builds
        copies of ``gossip_mix.cu`` that return at once (the launch
        floor), that skip loading W (zeros), and that skip the MMAs (their
        outputs are wrong: only their times are read), and times them
        with the kernel as it is and ``torch.matmul`` at P = 640 (the w2
        leaf), 64 and 50890.
    python3 scripts/kernel_ab.py schedule OLD_CSRC
        Builds ``gossip_schedule.cu`` from this checkout and from OLD_CSRC,
        checks the new kernel bitwise against the plain version (both
        designs, aligned and unaligned rows) in a child process with a
        time limit, then times both and ``torch.matmul`` on the densified
        W at the main path's shapes: n = 100, L = 11 (identity and ten
        random permutations), P = 50896 in float32 and bfloat16 and the
        unaligned P = 50890, old and new alternating.
    python3 scripts/kernel_ab.py scan OLD_CSRC
        Builds ``rglru_scan.cu`` from this checkout and from OLD_CSRC,
        checks the new kernel against the plain version (1e-4 float32,
        3e-2 bfloat16) and two of its launches against each other
        (bitwise) in a child process with a time limit, then times
        both at recurrentgemma-2b's (2, 4096, 2560) in float32 and
        bfloat16 and at (2, 32768, 2560) float32, old and new alternating;
        the new kernel's time includes zeroing its workspace.
    python3 scripts/kernel_ab.py gossip-designs
        Builds ``gossip_mix.cu`` as it is and a copy whose dispatch sends
        every case the W-resident FMA kernel takes to the K-tiled FMA
        kernel instead, and times both, and ``torch.matmul``, at the
        shapes the resident kernel serves.
    python3 scripts/kernel_ab.py auction OLD_CSRC
        Builds ``auction.cu`` from this checkout and from OLD_CSRC, runs
        both on the cold and warm STL-FW gradients of ``chip_smoke.py``'s
        phase 1 (``fw_gradients``) at n = 128, 512, 1024 and 2048 and
        checks that they return the same assignment, prices and counters
        (each kernel is held to the plain version by ``chip_smoke.py``),
        then times both, old and new alternating, 5 launches each (a
        solve is one launch of up to ~1 s).

Times are medians of 30 launches (CUDA events, a device sleep queued
ahead of each) unless a mode says otherwise. Libraries and ptxas reports go to ``build/kernel_ab/``.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
FLAGS = [*_build.NVCC_FLAGS, "-Xptxas", "-v"]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"


def nvcc_all(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """Build every ``name -> source`` at once; load each library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *FLAGS, "-o", str(OUT / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in jobs.items()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in jobs}


def device_ms(fn, launches: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(launches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# flash_attention: this checkout's bfloat16 kernel against another version
# ---------------------------------------------------------------------------

def _flash_fn(lib: ctypes.CDLL, csrc: Path):
    """The bf16 forward of a built ``flash_attention.cu``; a source whose
    entry takes the logits' scale (after the softcap) is passed 0, its
    D^-0.5 default, and an older one is called without it."""
    fn = lib.flash_attention_bf16
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scaled = "float softcap, float scale, void* stream" in csrc.read_text()
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, F] + ([F] if scaled else []) + [P]
    fn.restype = I

    def call(q, k, v, causal=True, window=None, softcap=0.0):
        out = torch.empty_like(q)
        B, S, H, D = q.shape
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2],
                    D, int(causal), 0 if window is None else window, softcap,
                    *([0.0] if scaled else []), torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"flash_attention_bf16: cudaError {status}")
        return out
    return call


def _qkv(B, S, H, Hkv, D, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=gen, device="cuda").bfloat16()
            for h in (H, Hkv, Hkv)]


def flash_check() -> None:
    """The new kernel against the plain version at small shapes (child process)."""
    call = _flash_fn(ctypes.CDLL(str(OUT / "flash_new.so")),
                     KERNELS / "flash_attention" / "csrc" / "flash_attention.cu")
    for B, S, H, Hkv, D, causal, window, softcap in [
            (1, 1, 2, 1, 64, True, None, 0.0), (1, 100, 4, 2, 256, True, 64, 0.0),
            (2, 129, 4, 4, 32, True, None, 0.0), (1, 300, 8, 4, 128, False, None, 50.0),
            (1, 2049, 10, 1, 256, True, 2048, 0.0), (2, 1000, 4, 1, 64, True, 100, 50.0),
            (1, 517, 2, 1, 32, False, 200, 0.0)]:
        q, k, v = _qkv(B, S, H, Hkv, D, S + D)
        out = call(q, k, v, causal, window, softcap).float()
        plain = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window,
                                    softcap=softcap)
        err = float((out - plain).abs().max())
        print(f"# check B{B} S{S} H{H}/{Hkv} D{D} causal={causal} window={window} "
              f"softcap={softcap}: max_abs_err {err:.3e}", flush=True)
        if not (bool(torch.isfinite(out).all()) and err <= 1e-2):
            raise RuntimeError("the new flash kernel disagrees with the plain version")


def flash(old_csrc: str) -> None:
    sources = {"flash_new": KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
               "flash_old": Path(old_csrc).resolve() / "flash_attention.cu"}
    libs = nvcc_all(sources)
    subprocess.run([sys.executable, __file__, "flash-check"], check=True, timeout=120)
    calls = {name: _flash_fn(lib, sources[name]) for name, lib in libs.items()}
    B, S, H, Hkv, D, W = 2, 4096, 10, 1, 256, 2048
    q, k, v = _qkv(B, S, H, Hkv, D, 20)
    plain = flash_attention_ref(q.float(), k.float(), v.float(), window=W)
    row = {"shape": [B, S, H, Hkv, D], "window": W}
    for rep in range(2):  # old, new, old, new
        for name in ("flash_old", "flash_new"):
            out = calls[name](q, k, v, window=W)
            row[f"{name}_max_abs_err"] = float((out.float() - plain).abs().max())
            row[f"{name}_ms_{rep}"] = device_ms(lambda: calls[name](q, k, v, window=W))
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).expand(B, H, S, D) for t in (k, v))
    row["sdpa_ms"] = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=band))
    print(json.dumps(row), flush=True)


def _kept_pairs(S: int, causal: bool, window: int | None) -> int:
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = i if causal else np.full(S, S - 1)
    return int((hi - lo + 1).sum())


def flash_bwd(old_csrc: str) -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops

    sources = {"flash_new": KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
               "flash_old": Path(old_csrc).resolve() / "flash_attention.cu"}
    libs = nvcc_all(sources)
    calls = {name: _flash_fn(lib, sources[name]) for name, lib in libs.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, S, H, Hkv, D, W in [(2, 1024, 16, 8, 128, None), (2, 4096, 10, 1, 256, 2048)]:
        q, k, v = _qkv(B, S, H, Hkv, D, S + D)
        dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda").bfloat16()
        flops = 10 * D * B * H * _kept_pairs(S, True, W)
        row = {"shape": [B, S, H, Hkv, D], "window": W, "bound_ms": flops / 989e12 * 1e3}
        _, o32, lse = fa_ops._forward(q, k, v, True, W, 0.0, None, save=True)
        grads = fa_ops._backward(q, k, v, dout, o32, lse, True, W, 0.0, None)
        row["bwd_ms"] = device_ms(
            lambda: fa_ops._backward(q, k, v, dout, o32, lse, True, W, 0.0, None))
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        plain = flash_attention_ref(*leaves, window=W)
        want = torch.autograd.grad(plain, leaves, dout.float(), retain_graph=True)
        row["max_abs_err"] = [float((g.float() - w).abs().max()) for g, w in zip(grads, want)]
        row["plain_bwd_ms"] = device_ms(
            lambda: torch.autograd.grad(plain, leaves, dout.float(), retain_graph=True))
        del plain, want, leaves
        i = torch.arange(S, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - (W or S))
        qt, kt, vt = (t.transpose(1, 2).repeat_interleave(H // t.shape[2], dim=1)
                      .detach().requires_grad_() for t in (q, k, v))
        mask = dict(is_causal=True) if W is None else dict(attn_mask=band)
        lib_out = sdpa(qt, kt, vt, **mask)
        dt = dout.transpose(1, 2)
        row["library_bwd_ms"] = device_ms(
            lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dt, retain_graph=True))
        del lib_out, qt, kt, vt
        for rep in range(2):  # old, new, old, new (grad off), then with the saved outputs
            for name in ("flash_old", "flash_new"):
                row[f"fwd_{name}_ms_{rep}"] = device_ms(lambda: calls[name](q, k, v, window=W))
        row["fwd_saving_ms"] = device_ms(
            lambda: fa_ops._forward(q, k, v, True, W, 0.0, None, save=True))
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# gossip_mix: this checkout's kernels against another version, and the
# W-resident FMA kernel against the K-tiled one
# ---------------------------------------------------------------------------

def _gossip_libs(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    libs = nvcc_all(jobs)
    P_ = ctypes.c_void_p
    for lib in libs.values():
        for sym in ("gossip_mix_f32", "gossip_mix_bf16"):
            getattr(lib, sym).argtypes = [P_, P_, P_, ctypes.c_int, ctypes.c_int64, P_]
            getattr(lib, sym).restype = ctypes.c_int
        lib.gossip_mix_design.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gossip_mix_design.restype = ctypes.c_int
    return libs


def _gossip_rows(libs: dict[str, ctypes.CDLL], cases) -> None:
    """Each library, then ``torch.matmul``, at each (n, P, dtype), with
    a row-stochastic W; errors against the float64 product."""
    for n, P, dtype in cases:
        gen = torch.Generator(device="cuda").manual_seed(n + P)
        theta = torch.randn((n, P), generator=gen, device="cuda").to(dtype)
        W = torch.rand((n, n), generator=gen, device="cuda")
        W = (W / W.sum(1, keepdim=True)).to(dtype)
        exact = W.double() @ theta.double()
        sym = "gossip_mix_f32" if dtype == torch.float32 else "gossip_mix_bf16"
        row = {"n": n, "P": P, "dtype": str(dtype).replace("torch.", "")}
        for rep in range(2):  # each library in turn, twice
            for name, lib in libs.items():
                out = torch.empty_like(theta)
                fn = getattr(lib, sym)

                def call():
                    status = fn(W.data_ptr(), theta.data_ptr(), out.data_ptr(), n, P,
                                torch.cuda.current_stream().cuda_stream)
                    if status:
                        raise RuntimeError(f"{name}: cudaError {status}")
                call()
                torch.cuda.synchronize()
                row[f"{name}_design"] = lib.gossip_mix_design(n, theta.element_size())
                row[f"{name}_max_abs_err"] = float((out.double() - exact).abs().max())
                row[f"{name}_ms_{rep}"] = device_ms(call)
        row["matmul_ms"] = device_ms(lambda: torch.matmul(W, theta))
        print(json.dumps(row), flush=True)


def gossip(old_csrc: str) -> None:
    libs = _gossip_libs({"gossip_mix_new": KERNELS / "gossip_mix" / "csrc" / "gossip_mix.cu",
                         "gossip_mix_old": Path(old_csrc).resolve() / "gossip_mix.cu"})
    f32 = torch.float32
    _gossip_rows(libs, [(100, 50890, f32), (100, 784 * 64, f32), (100, 64, f32),
                        (100, 640, f32), (100, 10, f32)])


def gossip_designs() -> None:
    src = (KERNELS / "gossip_mix" / "csrc" / "gossip_mix.cu").read_text()
    dispatch = "return fits ? kResident : kTiled;"
    if dispatch not in src:
        raise RuntimeError("gossip_mix.cu's dispatch line changed; update this script")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gossip_mix_tiled.cu").write_text(src.replace(dispatch, "return kTiled;"))
    libs = _gossip_libs({"gossip_mix": KERNELS / "gossip_mix" / "csrc" / "gossip_mix.cu",
                         "gossip_mix_tiled": OUT / "gossip_mix_tiled.cu"})
    bf16, f32 = torch.bfloat16, torch.float32
    _gossip_rows(libs, [(100, 50890, bf16), (161, 50890, f32), (176, 50890, f32),
                        (192, 50890, bf16), (129, 50896, f32), (100, 640, bf16)])


def gossip_floor() -> None:
    src = (KERNELS / "gossip_mix" / "csrc" / "gossip_mix.cu").read_text()
    cuts = {  # variant -> (text, replacement)
        "empty": ("  using K = Tf32x3<K8>;\n", "  if (P > 0) return;\n  using K = Tf32x3<K8>;\n"),
        "no_w_loads": ("const float w = (r < n && c < n) ? W[(int64_t)r * n + c] : 0.f;",
                       "const float w = 0.f;"),
        "no_mma": ("for (int kk = 0; kk < K8; ++kk) {\n      const uint32_t off",
                   "for (int kk = 0; kk < 0; ++kk) {\n      const uint32_t off"),
    }
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"gossip_mix": KERNELS / "gossip_mix" / "csrc" / "gossip_mix.cu"}
    for name, (text, repl) in cuts.items():
        if text not in src:
            raise RuntimeError(f"gossip_mix.cu changed where the {name} cut goes; update this script")
        (OUT / f"gossip_mix_{name}.cu").write_text(src.replace(text, repl))
        jobs[f"gossip_mix_{name}"] = OUT / f"gossip_mix_{name}.cu"
    libs = _gossip_libs(jobs)
    f32 = torch.float32
    _gossip_rows(libs, [(100, 640, f32), (100, 64, f32), (100, 50890, f32)])


# ---------------------------------------------------------------------------
# gossip_schedule and rglru_scan: this checkout's kernels against another version
# ---------------------------------------------------------------------------

def _schedule_fn(lib: ctypes.CDLL, dtype: torch.dtype):
    fn = getattr(lib, "gossip_schedule_f32" if dtype == torch.float32 else "gossip_schedule_bf16")
    P_ = ctypes.c_void_p
    fn.argtypes = [P_, P_, P_, P_, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, P_]
    fn.restype = ctypes.c_int

    def call(theta, gammas, perms):
        out = torch.empty_like(theta)
        n, P = theta.shape
        vec = 16 // theta.element_size()
        vectorized = P % vec == 0 and theta.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        status = fn(theta.data_ptr(), gammas.data_ptr(), perms.data_ptr(), out.data_ptr(), n, P,
                    perms.shape[0], int(vectorized), torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"gossip_schedule: cudaError {status}")
        return out
    return call


def _atoms(n: int, L: int, seed: int):
    """L atoms on n nodes: the identity and L - 1 random permutations,
    positive weights summing to 1."""
    rng = np.random.default_rng(seed)
    perms = np.stack([np.arange(n)] + [rng.permutation(n) for _ in range(L - 1)])
    g = rng.random(L) + 0.1
    return (torch.as_tensor(g / g.sum(), dtype=torch.float32, device="cuda"),
            torch.as_tensor(perms, dtype=torch.int32, device="cuda"))


def schedule_check() -> None:
    """The new kernel against the plain version, bitwise (child process)."""
    from repro_torch.kernels.gossip_mix.ref import gossip_schedule_ref

    lib = ctypes.CDLL(str(OUT / "schedule_new.so"))
    for n, P, L, dtype, offset in [(2, 1, 1, torch.float32, 0), (100, 50896, 11, torch.float32, 0),
                                   (100, 50890, 11, torch.float32, 0),
                                   (100, 50896, 11, torch.bfloat16, 0),
                                   (33, 4113, 5, torch.bfloat16, 1), (100, 4096, 16, torch.float32, 1),
                                   (512, 2051, 9, torch.float32, 0), (1500, 777, 3, torch.float32, 0),
                                   (3000, 300, 2, torch.float32, 0), (4096, 1000, 3, torch.bfloat16, 0)]:
        g, p = _atoms(n, L, n + P)
        gen = torch.Generator(device="cuda").manual_seed(P)
        theta = torch.randn(n * P + offset, generator=gen, device="cuda").to(dtype)[offset:].view(n, P)
        out = _schedule_fn(lib, dtype)(theta, g, p)
        plain = gossip_schedule_ref(theta, g, p)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, plain))
        print(f"# check n={n} P={P} L={L} {dtype} offset={offset}: bitwise {same}, max_abs_err "
              f"{float((out.float() - plain.float()).abs().max()):.3e}", flush=True)
        if not same:
            raise RuntimeError("the new gossip_schedule kernel disagrees with the plain version")


def schedule(old_csrc: str) -> None:
    libs = nvcc_all({"schedule_new": KERNELS / "gossip_mix" / "csrc" / "gossip_schedule.cu",
                     "schedule_old": Path(old_csrc).resolve() / "gossip_schedule.cu"})
    subprocess.run([sys.executable, __file__, "schedule-check"], check=True, timeout=180)
    g, p = _atoms(100, 11, 0)
    W = torch.zeros((100, 100), device="cuda")
    for l in range(11):  # the densified W, for the library call
        W[torch.arange(100, device="cuda"), p[l].long()] += g[l]
    for P, dtype in [(50896, torch.float32), (50896, torch.bfloat16), (50890, torch.float32)]:
        gen = torch.Generator(device="cuda").manual_seed(P)
        theta = torch.randn((100, P), generator=gen, device="cuda").to(dtype)
        row = {"n": 100, "P": P, "L": 11, "dtype": str(dtype).replace("torch.", "")}
        calls = {name: _schedule_fn(lib, dtype) for name, lib in libs.items()}
        for rep in range(2):  # old, new, old, new
            for name in ("schedule_old", "schedule_new"):
                row[f"{name}_ms_{rep}"] = device_ms(lambda: calls[name](theta, g, p))
        Wd = W.to(dtype)
        row["matmul_ms"] = device_ms(lambda: torch.matmul(Wd, theta))
        print(json.dumps(row), flush=True)


def _scan_fn(lib: ctypes.CDLL, dtype: torch.dtype):
    """A call of ``lib``'s scan; a library with ``rglru_scan_workspace``
    takes a workspace, zeroed here in the call."""
    fn = getattr(lib, "rglru_scan_f32" if dtype == torch.float32 else "rglru_scan_bf16")
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.restype = I_
    workspace = getattr(lib, "rglru_scan_workspace", None)
    if workspace is None:
        fn.argtypes = [P_, P_, P_, I_, I_, I_, P_]
    else:
        fn.argtypes = [P_, P_, P_, I_, I_, I_, P_, P_, P_]
        workspace.argtypes = [I_, I_, I_, P_, P_]
        workspace.restype = I_

    def call(a, b):
        h = torch.empty_like(a)
        B, S, D = a.shape
        stream = torch.cuda.current_stream().cuda_stream
        if workspace is None:
            status = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D, stream)
        else:
            zeroed, scratch = ctypes.c_int64(), ctypes.c_int64()
            workspace(B, S, D, ctypes.addressof(zeroed), ctypes.addressof(scratch))
            flags = torch.zeros(zeroed.value, dtype=torch.uint8, device="cuda")
            values = torch.empty(scratch.value, dtype=torch.uint8, device="cuda")
            status = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D, flags.data_ptr(),
                        values.data_ptr(), stream)
        if status:
            raise RuntimeError(f"rglru_scan: cudaError {status}")
        return h
    return call


def _scan_inputs(B: int, S: int, D: int, dtype: torch.dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand((B, S, D), generator=gen, device="cuda") * 0.399 + 0.6).to(dtype)
    b = (torch.randn((B, S, D), generator=gen, device="cuda") * 0.2).to(dtype)
    return a, b


def scan_check() -> None:
    """The new kernel against the plain version (child process)."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    lib = ctypes.CDLL(str(OUT / "scan_new.so"))
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    for B, S, D, dtype in [(1, 1, 1, torch.float32), (2, 255, 33, torch.float32),
                           (2, 256, 64, torch.float32), (2, 257, 2561, torch.bfloat16),
                           (3, 1001, 2561, torch.float32), (2, 4096, 2560, torch.float32),
                           (2, 4096, 2560, torch.bfloat16), (1, 65536, 96, torch.float32),
                           (2, 32768, 2560, torch.float32)]:
        a, b = _scan_inputs(B, S, D, dtype, S + D)
        call = _scan_fn(lib, dtype)
        out = call(a, b)
        again = call(a, b)  # back to back: the workspace is zeroed anew
        plain = rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        rerun = float((out.float() - again.float()).abs().max())
        print(f"# check B{B} S{S} D{D} {dtype}: max_abs_err {err:.3e}, rerun max |diff| "
              f"{rerun:.3e}", flush=True)
        if not (torch.allclose(out.float(), plain.float(), atol=tol[dtype], rtol=tol[dtype])
                and torch.allclose(again.float(), plain.float(), atol=tol[dtype], rtol=tol[dtype])):
            raise RuntimeError("the new rglru_scan kernel disagrees with the plain version")
        if not torch.equal(out, again):
            raise RuntimeError("two launches of the new rglru_scan kernel differ")


def scan(old_csrc: str) -> None:
    libs = nvcc_all({"scan_new": KERNELS / "rglru_scan" / "csrc" / "rglru_scan.cu",
                     "scan_old": Path(old_csrc).resolve() / "rglru_scan.cu"})
    subprocess.run([sys.executable, __file__, "scan-check"], check=True, timeout=180)
    for B, S, D, dtype in [(2, 4096, 2560, torch.float32), (2, 4096, 2560, torch.bfloat16),
                           (2, 32768, 2560, torch.float32)]:
        a, b = _scan_inputs(B, S, D, dtype, 32)
        row = {"shape": [B, S, D], "dtype": str(dtype).replace("torch.", "")}
        calls = {name: _scan_fn(lib, dtype) for name, lib in libs.items()}
        for rep in range(2):  # old, new, old, new
            for name in ("scan_old", "scan_new"):
                row[f"{name}_ms_{rep}"] = device_ms(lambda: calls[name](a, b))
        row["bytes_GB"] = 3 * B * S * D * a.element_size() / 1e9
        print(json.dumps(row), flush=True)
        del a, b
        torch.cuda.empty_cache()


def _cut_variants(src: Path, prefix: str, cuts: dict) -> dict[str, Path]:
    """``prefix`` -> ``src`` as it is, and ``prefix_<name>`` -> a copy of
    ``src`` with each (text, replacement) of ``cuts[name]`` applied."""
    text = src.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {prefix: src}
    for name, pairs in cuts.items():
        variant = text
        for old, new in pairs:
            if old not in variant:
                raise RuntimeError(f"{src.name} changed where the {name} cut goes; update this script")
            variant = variant.replace(old, new)
        (OUT / f"{prefix}_{name}.cu").write_text(variant)
        jobs[f"{prefix}_{name}"] = OUT / f"{prefix}_{name}.cu"
    return jobs


def schedule_floor() -> None:
    """Where the staged gossip_schedule kernel's time goes at n = 100,
    float32: copies that skip the gathers (copies and ring only), skip
    the copies, skip the stores, or add only the first 4 atoms (their
    outputs are wrong), take 256- or 128-byte rows, or keep 3 ring stages
    instead of up to 8; only their times are read."""
    jobs = _cut_variants(KERNELS / "gossip_mix" / "csrc" / "gossip_schedule.cu", "schedule", {
        "no_gather": [("    slot = slot + 1 == stages ? 0 : slot + 1;\n",
                       "    slot = slot + 1 == stages ? 0 : slot + 1;\n    if (n > 0) continue;\n")],
        "no_copies": [("    if (s < rg.n_tiles) load(s, s);", ""),
                      ("    if (t + ahead < rg.n_tiles) load(t + ahead, slot == 0 ? stages - 1 : slot - 1);",
                       "")],
        "no_stores": [("          if (c < cols)  // stored once",
                       "          if (c < cols && acc[k][0] == 1234.5f)  // stored once")],
        "atoms4": [("        for (int l0 = 0; l0 < L; l0 += U) {\n          // U atoms'",
                    "        for (int l0 = 0; l0 < 4; l0 += U) {\n          // U atoms'")],
        "rows256": [("for (int kw : {512, 256, 128, 64}) {", "for (int kw : {256, 128, 64}) {")],
        "rows128": [("for (int kw : {512, 256, 128, 64}) {", "for (int kw : {128, 64}) {")],
        "stages3": [("constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 3;")],
    })
    libs = nvcc_all(jobs)
    g, p = _atoms(100, 11, 0)
    for P, dtype in [(50896, torch.float32)]:
        gen = torch.Generator(device="cuda").manual_seed(P)
        theta = torch.randn((100, P), generator=gen, device="cuda").to(dtype)
        row = {"n": 100, "P": P, "L": 11, "dtype": str(dtype).replace("torch.", "")}
        for name, lib in libs.items():
            call = _schedule_fn(lib, dtype)
            row[f"{name}_ms"] = device_ms(lambda: call(theta, g, p))
        row["copy_ms"] = device_ms(lambda: theta.clone())
        print(json.dumps(row), flush=True)


def scan_floor() -> None:
    """Where the rglru_scan kernel's time goes: copies that skip the
    look-back's waits and folds (incoming state read unwaited; its output
    is wrong), that take another origin stride than 8 time tiles (1: each
    tile waits for its predecessor's end state; 4, 16, 32), or take other
    tiles than 32 features x 256 steps (16 warps of 16 steps): 64 x 128
    and 128 x 64 (2 and 4 feature groups), 128 steps (8 warps), 512 (32
    warps, or 16 warps of 32 steps). Timed at (2, 4096, 2560) float32 and
    bfloat16 and at (2, 32768, 2560) float32."""
    jobs = _cut_variants(KERNELS / "rglru_scan" / "csrc" / "rglru_scan.cu", "scan", {
        "no_lookback": [("      const int m = k - 1 - origin;\n      if (lane <= m) {",
                         "      const int m = 0;\n      if (lane < m) {")],
        "origin1": [("constexpr int kOrigin = 8;", "constexpr int kOrigin = 1;")],
        "origin4": [("constexpr int kOrigin = 8;", "constexpr int kOrigin = 4;")],
        "origin16": [("constexpr int kOrigin = 8;", "constexpr int kOrigin = 16;")],
        "origin32": [("constexpr int kOrigin = 8;", "constexpr int kOrigin = 32;")],
        "groups2": [("constexpr int kGroups = 1;", "constexpr int kGroups = 2;")],
        "groups4": [("constexpr int kGroups = 1;", "constexpr int kGroups = 4;")],
        "warps8": [("constexpr int kWarps = 16;", "constexpr int kWarps = 8;")],
        "warps32": [("constexpr int kWarps = 16;", "constexpr int kWarps = 32;")],
        "steps32": [("constexpr int kSteps = 16;", "constexpr int kSteps = 32;")],
    })
    libs = nvcc_all(jobs)
    for B, S, D, dtype in [(2, 4096, 2560, torch.float32), (2, 4096, 2560, torch.bfloat16),
                           (2, 32768, 2560, torch.float32)]:
        a, b = _scan_inputs(B, S, D, dtype, 32)
        row = {"shape": [B, S, D], "dtype": str(dtype).replace("torch.", "")}
        for name, lib in libs.items():
            call = _scan_fn(lib, dtype)
            row[f"{name}_ms"] = device_ms(lambda: call(a, b))
        row["copy_ms"] = device_ms(lambda: torch.add(a, b))  # reads a and b, writes one tensor
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# auction: this checkout's device auction against another version
# ---------------------------------------------------------------------------

def _auction_fn(lib: ctypes.CDLL):
    from repro_torch.kernels.auction import ops

    fn = lib.auction_f64
    fn.argtypes = ops._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def auction(old_csrc: str) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import fw_gradients  # noqa: E402  (its STL-FW gradients)
    from repro_torch.kernels.auction import ops  # noqa: E402

    libs = nvcc_all({"auction_old": Path(old_csrc) / "auction.cu",
                     "auction_new": KERNELS / "auction" / "csrc" / "auction.cu"})
    fns = {"old": _auction_fn(libs["auction_old"]), "new": _auction_fn(libs["auction_new"])}
    stream = torch.cuda.current_stream().cuda_stream
    for n in (128, 512, 1024, 2048):
        g0, g1, scale = fw_gradients(n)
        nf, ni = ops.work_sizes(n)
        cost = {k: torch.as_tensor(g, device="cuda") for k, g in (("cold", g0), ("warm", g1))}
        benefit = torch.empty((n, n), dtype=torch.float64, device="cuda")
        work = (torch.empty(nf, dtype=torch.float64, device="cuda"),
                torch.empty(ni, dtype=torch.int32, device="cuda"))

        def outputs():
            return (torch.empty(n, dtype=torch.int32, device="cuda"),
                    torch.empty(n, dtype=torch.float64, device="cuda"),
                    torch.empty(9, dtype=torch.int64, device="cuda"))

        def call(fn, kind, warm, out):
            wp, wc, scale_, have = warm
            col, prices, stats = out
            status = fn(cost[kind].data_ptr(), benefit.data_ptr(), wp.data_ptr(), wc.data_ptr(),
                        scale_, have, 1e-12, 3000.0, 0, 0, 64, 500 * n + 200_000, n,
                        prices.data_ptr(), col.data_ptr(), stats.data_ptr(),
                        work[0].data_ptr(), work[1].data_ptr(), stream)
            assert status == 0, status

        unset = (torch.zeros(n, dtype=torch.float64, device="cuda"),
                 torch.full((n,), -1, dtype=torch.int32, device="cuda"), 1.0, 0)
        results = {}
        for name, fn in fns.items():
            cold = outputs()
            call(fn, "cold", unset, cold)
            warm_in = (cold[1].clone(), cold[0].clone(), scale, 1)
            warm = outputs()
            call(fn, "warm", warm_in, warm)
            torch.cuda.synchronize()
            results[name] = (cold, warm, warm_in)
        same = all(torch.equal(a, b) for a, b in zip(results["old"][0] + results["old"][1],
                                                      results["new"][0] + results["new"][1]))
        assert same, f"n={n}: the two kernels disagree"
        for kind, warm_in in (("cold", unset), ("warm", results["new"][2])):
            out = outputs()
            row = {"n": n, "solve": kind, "rounds": int(results["new"][0 if kind == "cold" else 1][2][6]),
                   "old_ms": [], "new_ms": []}
            for name in ("old", "new", "new", "old"):
                row[f"{name}_ms"].append(device_ms(lambda: call(fns[name], kind, warm_in, out),
                                                   launches=5, warmup=1))
            print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] not in (["flash-check"], ["schedule-check"], ["scan-check"]):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if sys.argv[1:2] == ["flash"] and len(sys.argv) == 3:
        flash(sys.argv[2])
    elif sys.argv[1:2] == ["flash-bwd"] and len(sys.argv) == 3:
        flash_bwd(sys.argv[2])
    elif sys.argv[1:2] == ["gossip"] and len(sys.argv) == 3:
        gossip(sys.argv[2])
    elif sys.argv[1:2] == ["schedule"] and len(sys.argv) == 3:
        schedule(sys.argv[2])
    elif sys.argv[1:2] == ["scan"] and len(sys.argv) == 3:
        scan(sys.argv[2])
    elif sys.argv[1:2] == ["auction"] and len(sys.argv) == 3:
        auction(sys.argv[2])
    elif sys.argv[1:] == ["flash-check"]:
        flash_check()
    elif sys.argv[1:] == ["schedule-check"]:
        schedule_check()
    elif sys.argv[1:] == ["scan-check"]:
        scan_check()
    elif sys.argv[1:] == ["schedule-floor"]:
        schedule_floor()
    elif sys.argv[1:] == ["scan-floor"]:
        scan_floor()
    elif sys.argv[1:] == ["gossip-floor"]:
        gossip_floor()
    elif sys.argv[1:] == ["gossip-designs"]:
        gossip_designs()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
