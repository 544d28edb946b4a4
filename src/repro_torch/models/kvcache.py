"""KV caches for serving: full and window (ring) caches, and MLA's.

* ``init_full_cache``    -- (B, S_max, H_kv, D_h) keys/values + write index.
* ``init_window_cache``  -- ring buffer of size ``window``; used by
                            local-attention layers.
* ``init_mla_cache``     -- (B, S_max, r) compressed latents ``c_kv`` and
                            (B, S_max, d_rope) rotated ``k_rope`` + write
                            index (DeepSeek-V2's multi-head latent
                            attention caches no per-head keys). In the
                            long-context mode it is a ring of
                            ``long_context_window`` slots
                            (``ring=True``: ``update_mla`` writes it
                            with ``update_mla_ring``).

Recurrent states belong to their blocks (``models.rglru``). Keys are
stored post-RoPE, so decode never re-rotates history.

``index`` is a 0-d int64 tensor on the cache's device, as the reference
keeps a device int32 scalar: the writes go to slots computed from it on
the device (``index_copy_``) and advance it in place (``add_``), so a
decode step reads nothing on the host and a captured step (a CUDA graph,
``serve/engine.py``) writes the slot of the step it replays. int64, not
the reference's int32: ``index_copy_`` and advanced indexing take int64
indices, so the slots need no cast.

Unlike the reference's functional updates, ``update_*_cache`` write the
new positions into the cache's ``k`` / ``v`` buffers and its ``index``
in place, so decode allocates no new cache per token; they return a new
dict that shares the tensors. A write past the end of a full cache
cannot be seen without reading ``index``: the callers that know the
lengths check them on the host first (``check_fits``). A ring (the
window caches, MLA's long-context cache) has no end: its writes wrap,
slot = absolute position mod its length, and nothing is refused. The
``init_*`` functions put the cache on ``device`` (None = CUDA).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = [
    "init_full_cache",
    "init_window_cache",
    "init_mla_cache",
    "update_full_cache",
    "update_mla",
    "update_mla_cache",
    "update_mla_ring",
    "update_window_cache",
    "check_fits",
]


def _zeros(batch: int, length: int, n_kv: int, head_dim: int, dtype, device) -> torch.Tensor:
    return torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                       device=resolve_device(device))


def _index(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=resolve_device(device))


def init_full_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                    device: torch.device | str | None = None) -> dict:
    return {
        "k": _zeros(batch, max_len, n_kv, head_dim, dtype, device),
        "v": _zeros(batch, max_len, n_kv, head_dim, dtype, device),
        "index": _index(device),  # number of valid positions
    }


def init_window_cache(batch: int, window: int, n_kv: int, head_dim: int, dtype,
                      device: torch.device | str | None = None) -> dict:
    return {
        "k": _zeros(batch, window, n_kv, head_dim, dtype, device),
        "v": _zeros(batch, window, n_kv, head_dim, dtype, device),
        "index": _index(device),  # absolute position counter
    }


def init_mla_cache(batch: int, max_len: int, kv_lora_rank: int, rope_dim: int, dtype,
                   device: torch.device | str | None = None, *, ring: bool = False) -> dict:
    """MLA's cache of ``max_len`` slots, written by ``update_mla``: an
    append (``update_mla_cache``; as for the full caches, a write past
    ``max_len`` is refused on the host, ``check_fits``) or, made with
    ``ring`` (the long-context mode), a ring of ``max_len`` slots that
    wraps (``update_mla_ring``). The cache says which: ``"ring": True``."""
    device = resolve_device(device)
    cache = {
        "c_kv": torch.zeros((batch, max_len, kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, rope_dim), dtype=dtype, device=device),
        "index": _index(device),  # positions written so far
    }
    if ring:
        cache["ring"] = True
    return cache


def check_fits(max_len: int, index: int, s_new: int) -> None:
    """Raise before a write of ``s_new`` positions at ``index`` (both known
    on the host) overruns a full cache of ``max_len`` positions. Rings
    are not checked: their writes wrap."""
    if index + s_new > max_len:
        raise ValueError(f"full cache of {max_len} positions cannot take {s_new} more at {index}")


def _write(cache: dict, slots: torch.Tensor, advance: int, **new: torch.Tensor) -> dict:
    """Write each ``new[name]`` into ``cache[name]`` at ``slots`` (axis 1)
    and advance the index, in place; a new dict sharing the tensors."""
    for name, values in new.items():
        cache[name].index_copy_(1, slots, values.to(cache[name].dtype))
    cache["index"].add_(advance)
    return dict(cache)


def _append(cache: dict, kind: str, **new: torch.Tensor) -> dict:
    """Write ``S_new`` positions at the current index. Only a write longer
    than the whole cache raises here; one that starts too late is the
    caller's to refuse (``check_fits``)."""
    first = next(iter(new))
    length, s_new = cache[first].shape[1], new[first].shape[1]
    if s_new > length:
        raise ValueError(f"{kind} cache of {length} positions cannot take {s_new} more")
    slots = cache["index"] + torch.arange(s_new, device=cache[first].device)
    return _write(cache, slots, s_new, **new)


def update_full_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Append ``S_new`` positions at the current index (decode: S_new = 1)."""
    return _append(cache, "full", k=k_new, v=v_new)


def _ring(cache: dict, **new: torch.Tensor) -> dict:
    """Ring write of ``S_new`` positions (slot = absolute position mod the
    ring's length, from the device ``index``). A write longer than the
    ring keeps only its last ``length`` positions (the only ones that
    survive), so slots stay unique."""
    first = next(iter(new))
    length, s_new = cache[first].shape[1], new[first].shape[1]
    skip = max(s_new - length, 0)
    positions = cache["index"] + torch.arange(skip, s_new, device=cache[first].device)
    return _write(cache, torch.remainder(positions, length), s_new,
                  **{name: values[:, skip:] for name, values in new.items()})


def update_window_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Ring-buffer write of ``S_new`` positions (slot = abs_pos mod window).

    A prefill longer than the window keeps only its last ``window``
    positions (the only ones that survive), so slots stay unique.
    """
    return _ring(cache, k=k_new, v=v_new)


def update_mla_cache(cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor) -> dict:
    """Append ``S_new`` latents at the current index, as ``update_full_cache``
    does keys and values."""
    return _append(cache, "MLA", c_kv=c_kv, k_rope=k_rope)


def update_mla_ring(cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor) -> dict:
    """Ring write of ``S_new`` latents (the long-context mode): slot =
    absolute position mod the ring's length, the last ``length``
    positions of a longer prefill kept. The reference means the same
    ring (``attention.py:408-414``), but its prefill write is a
    ``dynamic_update_slice`` that clamps its start: a prefill of S > L
    positions lands at slots 0..L-1 whatever S mod L, where the decode
    steps' ``index mod L`` expects position p at slot p mod L. The two
    agree when S <= L or L divides S."""
    return _ring(cache, c_kv=c_kv, k_rope=k_rope)


def update_mla(cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor) -> dict:
    """The write the cache was made for (``init_mla_cache``): around the
    ring if it is one, else an append."""
    write = update_mla_ring if cache.get("ring", False) else update_mla_cache
    return write(cache, c_kv, k_rope)
