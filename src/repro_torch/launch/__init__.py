"""Launchers: device meshes and the H100's datasheet constants
(``mesh``), the dry run of every architecture and input shape on a fake
process group of 256 or 512 ranks (``dryrun``), the roofline over its
records (``roofline``) and the training CLI (``train``).

``python -m repro_torch.launch.dryrun`` / ``.roofline`` / ``.train`` run
them; importing this package touches no process group.
"""

from .mesh import H100, make_host_mesh, make_production_mesh

__all__ = ["H100", "make_host_mesh", "make_production_mesh"]
