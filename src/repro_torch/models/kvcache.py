"""KV caches for serving: full and window (ring) caches.

* ``init_full_cache``    -- (B, S_max, H_kv, D_h) keys/values + write index.
* ``init_window_cache``  -- ring buffer of size ``window``; used by
                            local-attention layers.

Recurrent states belong to their blocks (``models.rglru``). Keys are
stored post-RoPE, so decode never re-rotates history.

Unlike the reference's functional updates, ``update_*_cache`` write the
new positions into the cache's ``k`` / ``v`` buffers in place, so decode
allocates no new cache per token. They return a new dict that shares the
buffers; ``index`` is a host integer, so masks need no device read.
The ``init_*`` functions put the cache on ``device`` (None = CUDA).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = [
    "init_full_cache",
    "init_window_cache",
    "update_full_cache",
    "update_window_cache",
]


def _zeros(batch: int, length: int, n_kv: int, head_dim: int, dtype, device) -> torch.Tensor:
    return torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                       device=resolve_device(device))


def init_full_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                    device: torch.device | str | None = None) -> dict:
    return {
        "k": _zeros(batch, max_len, n_kv, head_dim, dtype, device),
        "v": _zeros(batch, max_len, n_kv, head_dim, dtype, device),
        "index": 0,  # number of valid positions
    }


def init_window_cache(batch: int, window: int, n_kv: int, head_dim: int, dtype,
                      device: torch.device | str | None = None) -> dict:
    return {
        "k": _zeros(batch, window, n_kv, head_dim, dtype, device),
        "v": _zeros(batch, window, n_kv, head_dim, dtype, device),
        "index": 0,  # absolute position counter
    }


def update_full_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Append ``S_new`` positions at the current index (decode: S_new = 1)."""
    idx = cache["index"]
    s_new = k_new.shape[1]
    if idx + s_new > cache["k"].shape[1]:
        raise ValueError(
            f"full cache of {cache['k'].shape[1]} positions cannot take {s_new} more at {idx}"
        )
    cache["k"][:, idx : idx + s_new] = k_new
    cache["v"][:, idx : idx + s_new] = v_new
    return {"k": cache["k"], "v": cache["v"], "index": idx + s_new}


def update_window_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Ring-buffer write of ``S_new`` positions (slot = abs_pos mod window).

    A prefill longer than the window keeps only its last ``window``
    positions (the only ones that survive), so slots stay unique.
    """
    window = cache["k"].shape[1]
    idx = cache["index"]
    s_new = k_new.shape[1]
    if s_new > window:
        k_new = k_new[:, -window:]
        v_new = v_new[:, -window:]
        start, count = idx + s_new - window, window
    else:
        start, count = idx, s_new
    slots = torch.remainder(
        torch.arange(start, start + count, device=cache["k"].device), window
    )
    cache["k"].index_copy_(1, slots, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v_new.to(cache["v"].dtype))
    return {"k": cache["k"], "v": cache["v"], "index": idx + s_new}
