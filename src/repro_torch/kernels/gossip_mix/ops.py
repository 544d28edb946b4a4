"""Public wrappers for the gossip mixing kernels.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/gossip_schedule.cu``, ``csrc/gossip_mix.cu``), built with nvcc at
first use; there is no fallback to another implementation on the card.
On a CPU tensor it runs the plain version in ``ref.py``. (The reference's
``ops.py`` runs its Pallas kernels in interpret mode everywhere but on a
TPU; this port launches its own CUDA kernels on the card instead.)

The kernels take any P and mask the ragged edge themselves, so nothing
here pads the parameter axis. ``gossip_apply`` picks between the dense
and schedule kernels with the ``preferred_transport`` cost model.

``launch_counts`` holds one plain integer per kernel, raised by one at
every launch and nowhere else: a run reads it to show which kernels its
mixing went through.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ref import gossip_mix_ref, gossip_schedule_ref

__all__ = [
    "gossip_mix",
    "gossip_schedule",
    "gossip_apply",
    "gossip_mix_design",
    "gossip_schedule_design",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"gossip_schedule": 0, "gossip_mix": 0}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "gossip_schedule": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    "gossip_mix": [_P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernel_fn(kernel: str, dtype: torch.dtype):
    from repro_torch.kernels import _build

    return _build.kernel_function(kernel, f"{kernel}_{_DTYPES[dtype]}", _ARGTYPES[kernel])


def _check_status(kernel: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")


def _check_theta(theta: torch.Tensor) -> None:
    if not isinstance(theta, torch.Tensor) or theta.ndim != 2:
        raise ValueError(f"theta must be a 2-D (n, P) tensor, got {type(theta).__name__}"
                         f" {tuple(getattr(theta, 'shape', ()))}")
    if theta.dtype not in _DTYPES:
        raise TypeError(f"theta dtype must be float32 or bfloat16, got {theta.dtype}")
    if theta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {theta.device}")
    if not theta.is_contiguous():
        raise ValueError("theta must be contiguous (row-major (n, P))")


def _operand(x, dtype: torch.dtype, device: torch.device, name: str) -> torch.Tensor:
    """A host array or a tensor on ``device`` as a contiguous ``dtype`` tensor."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device} but theta is on {device}")
        return x.to(dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def gossip_schedule(theta: torch.Tensor, coeffs, perms) -> torch.Tensor:
    """Birkhoff mixing ``out = sum_l coeffs[l] theta[perms[l]]`` for (n, P) theta.

    ``coeffs`` (L,) and ``perms`` (L, n) may be host arrays or tensors on
    theta's device; every entry of ``perms`` must lie in ``[0, n)``. Host
    arrays are checked here; device tensors are checked where they are
    made (``schedule_to_arrays``, ``BirkhoffSchedule.operands``,
    ``convert.schedule_arrays_from_numpy``), since a check here would
    wait for the device. Accumulates in float32, returns theta's dtype.
    """
    _check_theta(theta)
    n, P = theta.shape
    if not isinstance(perms, torch.Tensor):
        perms_host = np.asarray(perms)
        if perms_host.size and (perms_host.min() < 0 or perms_host.max() >= n):
            raise ValueError(f"perms entries must lie in [0, {n})")
    g = _operand(coeffs, torch.float32, theta.device, "coeffs")
    pm = _operand(perms, torch.int32, theta.device, "perms")
    L = pm.shape[0] if pm.ndim == 2 else -1
    if pm.shape != (L, n):
        raise ValueError(f"perms must be (L, n={n}), got {tuple(pm.shape)}")
    if g.shape != (L,):
        raise ValueError(f"coeffs must be ({L},), got {tuple(g.shape)}")
    if theta.device.type == "cpu":
        return gossip_schedule_ref(theta, g, pm)
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    vec = 16 // theta.element_size()
    vectorized = (
        P % vec == 0 and theta.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    )
    with torch.cuda.device(theta.device):
        fn = _kernel_fn("gossip_schedule", theta.dtype)
        status = fn(
            theta.data_ptr(), g.data_ptr(), pm.data_ptr(), out.data_ptr(),
            n, P, L, int(vectorized), torch.cuda.current_stream().cuda_stream,
        )
    _check_status("gossip_schedule", status)
    launch_counts["gossip_schedule"] += 1
    return out


def gossip_mix(theta: torch.Tensor, W) -> torch.Tensor:
    """Dense mixing ``out[i] = sum_j W[i, j] theta[j]`` for (n, P) theta.

    W is cast to theta's dtype first, as the reference's ``ops.py`` does:
    a bfloat16 theta mixes with a bfloat16-quantized W. The product
    accumulates in float32 and returns theta's dtype; on the card a
    float32 theta with n <= 128 multiplies as 3xTF32 on the tensor cores
    (each product keeps ~21 of float32's 24 bits; see
    ``gossip_mix_design``).
    """
    _check_theta(theta)
    n, P = theta.shape
    Wt = _operand(W, theta.dtype, theta.device, "W")
    if Wt.shape != (n, n):
        raise ValueError(f"W must be (n, n) = ({n}, {n}), got {tuple(Wt.shape)}")
    if theta.device.type == "cpu":
        return gossip_mix_ref(theta, Wt)
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    with torch.cuda.device(theta.device):
        fn = _kernel_fn("gossip_mix", theta.dtype)
        status = fn(
            Wt.data_ptr(), theta.data_ptr(), out.data_ptr(), n, P,
            torch.cuda.current_stream().cuda_stream,
        )
    _check_status("gossip_mix", status)
    launch_counts["gossip_mix"] += 1
    return out


_MIX_DESIGNS = ("tf32x3-mma w-resident", "fma w-resident", "fma k-tiled")


def gossip_mix_design(n: int, dtype: torch.dtype, device=None) -> str:
    """Which ``gossip_mix`` kernel runs for ``n`` nodes on the card:
    ``"tf32x3-mma w-resident"`` (float32, n <= 128: 3xTF32 on the tensor
    cores, W in registers), ``"fma w-resident"`` (W staged once per block
    in shared memory) or ``"fma k-tiled"`` (W too large for that)."""
    from repro_torch.kernels import _build

    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        fn = _build.kernel_function("gossip_mix", "gossip_mix_design",
                                    [ctypes.c_int, ctypes.c_int])
        design = fn(n, torch.empty((), dtype=dtype).element_size())
    if design < 0:
        raise RuntimeError(f"gossip_mix_design failed: cudaError {-design}")
    return _MIX_DESIGNS[design]


def gossip_schedule_design(n: int, L: int, dtype: torch.dtype, device=None) -> str:
    """Which ``gossip_schedule`` kernel runs for n rows, L atoms and
    ``dtype`` on the card: ``"staged tile, <bytes>-byte rows x <k>
    stages"`` (float32: column tiles of all n rows staged in shared
    memory, theta read from device memory once) or ``"l2 gather"``
    (bfloat16, or a perms table and n rows of 64 bytes too large for a
    block's shared memory: the source rows are gathered through L2)."""
    from repro_torch.kernels import _build

    tile, stages = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        fn = _build.kernel_function("gossip_schedule", "gossip_schedule_design",
                                    [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P])
        design = fn(n, L, torch.empty((), dtype=dtype).element_size(),
                    ctypes.addressof(tile), ctypes.addressof(stages))
    if design < 0:
        raise RuntimeError(f"gossip_schedule_design failed: cudaError {-design}")
    if design == 1:
        return "l2 gather"
    return f"staged tile, {tile.value}-byte rows x {stages.value} stages"


def gossip_apply(theta: torch.Tensor, W=None, schedule=None) -> torch.Tensor:
    """Cost-model dispatch between the dense and schedule kernels.

    ``schedule`` is a ``repro_torch.core.mixing.BirkhoffSchedule``. With
    both W and schedule available the ``preferred_transport`` model
    picks; with only one available that one runs.
    """
    from repro_torch.core.mixing import preferred_transport

    if schedule is None and W is None:
        raise ValueError("gossip_apply needs W or schedule")
    if schedule is not None:
        # the kernel gathers EVERY atom, identities included, so all atoms
        # count as cost here
        choice = "schedule" if W is None else preferred_transport(theta.shape[0], schedule.n_atoms)
        if choice == "schedule":
            return gossip_schedule(theta, *schedule.operands(theta.device))
    return gossip_mix(theta, W)
