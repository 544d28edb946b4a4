from . import ops, ref
from .ops import flash_attention, launch_counts, reset_launch_counts
from .ref import flash_attention_ref

__all__ = ["ops", "ref", "flash_attention", "flash_attention_ref", "launch_counts",
           "reset_launch_counts"]
