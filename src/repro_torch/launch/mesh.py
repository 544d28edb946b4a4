"""Device meshes of joined ranks, and the constants of one NVIDIA H100 SXM.

``make_production_mesh`` builds the deployment mesh on whatever process
group is initialised: ``(data=16, model=16)``, 256 ranks, or ``(pod=2,
data=16, model=16)``, 512 ranks (a pod is 256 cards; the ``pod`` axis
carries cross-pod D-SGD gossip, ``dsgd_pod``). The dry run builds it on a
fake process group (``launch/dryrun.py``); on cards it needs that many
ranks. ``make_host_mesh`` is ``train.sharding.make_mesh`` on
``(data, model)``. Both are functions: importing this module touches no
process group.

``H100`` holds the constants the roofline (``launch/roofline.py``) divides
by, each from NVIDIA's H100 SXM datasheet (public): dense bfloat16
tensor-core FLOP/s, HBM3 bandwidth and size, NVLink bandwidth per
direction (900 GB/s bidirectional), the GPUs an HGX node joins by
NVLink, and one 400 Gb/s NIC a GPU (ConnectX-7) between nodes. They are a
datasheet's, not measured here; the card a run used is named by
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` beside
its numbers.
"""

from __future__ import annotations

from repro_torch.train.sharding import make_mesh

__all__ = ["H100", "make_production_mesh", "make_host_mesh", "MESHES"]

H100 = {
    "peak_flops_bf16": 989e12,  # FLOP/s, dense bf16 tensor cores (H100 SXM datasheet)
    "hbm_bw": 3.35e12,  # bytes/s, HBM3 (H100 SXM datasheet)
    "hbm_bytes": 80 * 2**30,  # HBM3 capacity (H100 SXM datasheet)
    "nvlink_bw": 450e9,  # bytes/s per direction: 900 GB/s NVLink bidirectional (datasheet)
    "gpus_per_node": 8,  # an HGX H100 node: 8 GPUs on NVLink switches (datasheet)
    "net_bw": 50e9,  # bytes/s: one 400 Gb/s NIC a GPU between nodes (ConnectX-7)
}

# name -> (shape, axis names, outer first): the production meshes, and the
# small ones the tests run; the dry run and the roofline read this table
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False):
    """The deployment mesh, 16x16 or (multi-pod) 2x16x16, on the default
    process group (256 or 512 ranks)."""
    shape, names = MESHES["2x16x16" if multi_pod else "16x16"]
    return make_mesh(shape, names)


def make_host_mesh(data: int = 4, model: int = 2):
    """A ``(data, model)`` mesh over the joined ranks (``data * model`` of
    them)."""
    return make_mesh((data, model), ("data", "model"))
