"""The port's kernel build key, on the CPU (no nvcc needed).

A built library is named by a hash of the flags and of every file a
build of the source can read: the ``.cu`` itself, the other files of its
``csrc/`` directory and the shared header directory (``INCLUDE_DIRS``).
Editing only a header must therefore give another library path, or the
card would keep running a stale library."""
from pathlib import Path

import pytest

from repro_torch import kernels


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    common = tmp_path / "common"
    csrc.mkdir()
    common.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include "h.cuh"\n')
    (csrc / "k.cuh").write_text("// local header\n")
    (common / "h.cuh").write_text("// shared header\n")
    monkeypatch.setattr(kernels, "INCLUDE_DIRS", (common,))
    return csrc / "k.cu", csrc / "k.cuh", common / "h.cuh"


def test_library_path_is_stable(sources):
    source, _, _ = sources
    assert kernels._library_path(source) == kernels._library_path(source)
    assert kernels._library_path(source).name.startswith("k_")


@pytest.mark.parametrize("edited", [0, 1, 2],
                         ids=["source", "csrc header", "shared header"])
def test_editing_any_input_changes_the_library_path(sources, edited):
    before = kernels._library_path(sources[0])
    path = sources[edited]
    path.write_text(path.read_text() + "// edited\n")
    assert kernels._library_path(sources[0]) != before


def test_a_new_header_changes_the_library_path(sources):
    source, header, _ = sources
    before = kernels._library_path(source)
    (header.parent / "extra.cuh").write_text("// new\n")
    assert kernels._library_path(source) != before


def test_flags_are_part_of_the_key(sources, monkeypatch):
    source = sources[0]
    before = kernels._library_path(source)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels._library_path(source) != before


def test_the_shared_header_directory_is_the_packages():
    (common,) = kernels.INCLUDE_DIRS
    assert common == Path(kernels.__file__).resolve().parent / "common"
    assert (common / "hopper.cuh").is_file()
