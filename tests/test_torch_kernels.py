"""How the port names its kernel libraries, checked on the CPU.

A library's file name carries a digest of its source and of every local
header the source includes, so a changed header is rebuilt and never
loaded stale. Nothing here needs ``nvcc``: the digest is read from a
temporary copy of ``csrc/``.
"""

import shutil

import pytest

from multiverso_tpu_torch import kernels

HEADER = "mma_sm90.cuh"
LAUNCH_HEADER = "launch.cuh"


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The package's ``csrc/`` copied under a temporary package root that
    ``kernels`` reads instead of its own."""
    shutil.copytree(kernels._PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(kernels, "_PKG", tmp_path)
    return tmp_path / "csrc"


def _names():
    return {name: kernels.library_path(name).name for name in kernels.SOURCES}


def test_flash_sources_include_the_shared_header():
    for name in ("flash_fwd", "flash_bwd"):
        assert [p.name for p in kernels.source_files(name)] == [
            kernels.SOURCES[name], HEADER]
    for name in ("row_gather", "row_scatter_add"):
        assert [p.name for p in kernels.source_files(name)] == [
            kernels.SOURCES[name], LAUNCH_HEADER]


@pytest.mark.parametrize("edited", [HEADER, LAUNCH_HEADER, "flash_fwd.cu",
                                    "row_gather.cu"])
def test_library_name_follows_its_files(csrc_copy, edited):
    """Editing a file renames exactly the libraries built from it: the
    tile header renames both flash libraries, the launch header both row
    libraries, a source only its own."""
    before = _names()
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    after = _names()
    users = {name for name in kernels.SOURCES
             if edited in [p.name for p in kernels.source_files(name)]}
    assert users == {HEADER: {"flash_fwd", "flash_bwd"},
                     LAUNCH_HEADER: {"row_gather", "row_scatter_add"}}.get(
                         edited, {edited.rsplit(".", 1)[0]})
    for name in kernels.SOURCES:
        assert (after[name] != before[name]) == (name in users), name


def test_nested_header_is_followed(csrc_copy):
    """A header that the shared header includes is part of the digest."""
    (csrc_copy / "inner.cuh").write_text("// v1\n")
    with open(csrc_copy / HEADER, "a") as f:
        f.write('\n#include "inner.cuh"\n')
    before = kernels.library_path("flash_fwd").name
    (csrc_copy / "inner.cuh").write_text("// v2\n")
    assert kernels.library_path("flash_fwd").name != before
    assert "inner.cuh" in [p.name for p in kernels.source_files("flash_bwd")]
