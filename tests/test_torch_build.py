"""The kernel build keys each library by its source and the headers it includes.

A kernel whose source includes a header (``flash_attention.cu`` includes
``flash_attention_wgmma.cuh``) must build anew when only the header
changes; otherwise a stale library would be loaded. A kernel's library
must not build anew when another kernel's source changes
(``gossip_mix.cu`` and ``gossip_schedule.cu`` share one ``csrc/``). Runs
on the CPU: it computes library names, it builds nothing.
"""

import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

KERNELS = Path(_build.__file__).resolve().parent


@pytest.fixture
def kernels_copy(tmp_path, monkeypatch):
    """A copy of the kernel sources that ``_build`` reads instead."""
    copy = tmp_path / "src" / "repro_torch" / "kernels"
    for name, rel in _build.KERNEL_SOURCES.items():
        csrc = (KERNELS / rel).parent
        shutil.copytree(csrc, copy / csrc.relative_to(KERNELS), dirs_exist_ok=True)
    monkeypatch.setattr(_build, "_PKG", copy)
    return copy


def _names() -> dict:
    return {name: _build._target(name)[1].name for name in _build.KERNEL_SOURCES}


def test_editing_a_header_renames_its_kernels_library(kernels_copy):
    header = kernels_copy / "flash_attention" / "csrc" / "flash_attention_wgmma.cuh"
    assert header.exists()
    before = _names()
    header.write_text(header.read_text() + "\n// edited\n")
    after = _names()
    # the forward's source and the backward's both include it
    including = {"flash_attention", "flash_attention_bwd"}
    assert all(after[k] != before[k] for k in including)
    # the other kernels' libraries keep their names
    assert {k: v for k, v in after.items() if k not in including} == {
        k: v for k, v in before.items() if k not in including}


@pytest.mark.parametrize("name", sorted(_build.KERNEL_SOURCES))
def test_library_name_follows_its_sources_only(kernels_copy, name):
    src = kernels_copy / _build.KERNEL_SOURCES[name]
    first = _build._target(name)[1].name
    assert first == _build._target(name)[1].name  # stable
    assert first.startswith(f"{name}-") and first.endswith(".so")
    before = _names()
    src.write_text(src.read_text() + "\n")
    after = _names()
    assert after[name] != first
    # every other kernel's library keeps its name
    assert {k: v for k, v in after.items() if k != name} == {
        k: v for k, v in before.items() if k != name}


def test_a_file_nothing_includes_renames_no_library(kernels_copy):
    before = _names()
    for rel in set(_build.KERNEL_SOURCES.values()):
        (kernels_copy / rel).parent.joinpath("notes.txt").write_text("unrelated\n")
    assert _names() == before
