from . import ops, ref
from .ops import launch_counts, reset_launch_counts, rglru_scan
from .ref import rglru_scan_ref

__all__ = ["ops", "ref", "rglru_scan", "rglru_scan_ref", "launch_counts", "reset_launch_counts"]
