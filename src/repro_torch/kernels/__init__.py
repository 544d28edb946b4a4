"""Hand-written Hopper (sm_90a) kernels for the port's hot spots.

Each kernel follows the reference's convention (``repro/kernels``):
  csrc/<name>.cu -- the CUDA C++ kernel, with a plain C entry point
  ops.py         -- checks, dispatch and launch counters (public API)
  ref.py         -- the plain PyTorch version of the same function

``_build.py`` compiles the sources with nvcc at first use and loads them
with ctypes. Nothing is built or imported from CUDA at import time.
"""

from . import flash_attention, gossip_mix, rglru_scan

__all__ = ["flash_attention", "gossip_mix", "rglru_scan"]
