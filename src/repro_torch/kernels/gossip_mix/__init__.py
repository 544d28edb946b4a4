from . import ops, ref
from .ops import gossip_apply, gossip_mix, gossip_schedule, launch_counts, reset_launch_counts
from .ref import gossip_mix_ref, gossip_schedule_ref

__all__ = [
    "ops",
    "ref",
    "gossip_apply",
    "gossip_mix",
    "gossip_mix_ref",
    "gossip_schedule",
    "gossip_schedule_ref",
    "launch_counts",
    "reset_launch_counts",
]
