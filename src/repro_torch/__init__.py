"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

The port runs the paper's main path on one NVIDIA H100: a label-skew
partition gives Pi, STL-FW learns a sparse W as Birkhoff atoms, and the
n-node D-SGD simulator trains on that topology with its gossip step in
the hand-written CUDA kernels of ``kernels/gossip_mix``.

The D-SGD drivers also run as captured CUDA graphs (``rollout="scan"``,
``train/rollout.py``) and adapt the topology online (``online/``: a
streaming Pi estimate, a drift detector, warm STL-FW refreshes swapped
into the running graph by value). The robustness layer rides the same
graphs: EF-compressed gossip (``core/compression.py``), bounded-delay,
straggler and corrupted gossip (``core/mixing.py``), in-rollout health
probes (``obs/probes.py``) and the crash-resumable fault runner
(``faults/``, ``train/checkpoints.py``).

This package imports ``torch`` and never ``jax``, and nothing of
``repro``: the numpy and pure-Python host modules it needs are kept as
copies (``data/synthetic.py``, ``data/partition.py``, ``data/drift.py``,
``core/topology.py``, ``core/heterogeneity.py``, ``core/assignment.py``,
``core/stl_fw.py``, ``core/dcliques.py``, ``core/theory.py``,
``core/dynamic.py``, ``online/streaming.py``, ``obs/report.py``, and
``faults/plan.py`` / ``faults/quarantine.py`` with their imports pointed
at the port; ``obs/trace.py`` began as one and now also names its spans
in the profiler's trace). Entry points run on the card unless the caller
passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
