"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["resolve_device", "shapes_only"]

_META = [False]


@contextlib.contextmanager
def shapes_only() -> Iterator[None]:
    """Let ``resolve_device`` take the ``meta`` device inside this block:
    the shape-only runs of the dry run (``launch/dryrun.py``) and the
    abstract caches of ``serve.engine.make_serve_setup``. Nothing computes
    on meta outside it."""
    was = _META[0]
    _META[0] = True
    try:
        yield
    finally:
        _META[0] = was


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the CPU.

    ``None`` means ``cuda``. A CUDA device without CUDA available raises
    ``RuntimeError``: the port never falls back to the CPU silently.
    ``meta`` is taken only inside :func:`shapes_only`.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
    elif dev.type == "meta" and _META[0]:
        pass
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
