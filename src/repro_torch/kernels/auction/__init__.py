from . import ops, ref
from .ops import auction, launch_counts, reset_launch_counts
from .ref import auction_ref

__all__ = ["ops", "ref", "auction", "auction_ref", "launch_counts", "reset_launch_counts"]
