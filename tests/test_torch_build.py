"""The port's kernel build cache (``utils/cuda_build.py``): a library's
name is keyed by its source, every shared header in ``csrc/`` and the nvcc
flags, so a changed header never loads a stale build. Needs no nvcc."""

import os
import shutil

import pytest

from physically_based_renderer_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    return src


@pytest.mark.parametrize("name", ["raster_shade_row", "shade_backward", "shade_forward"])
def test_library_path_follows_headers(csrc_copy, name):
    before = cuda_build.library_path(name)
    assert os.path.basename(before).startswith(name + "-") and before.endswith(".so")
    assert cuda_build.library_path(name) == before  # deterministic
    header = csrc_copy / "shade_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build.library_path(name)
    assert after != before
    (csrc_copy / "unrelated.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path(name) != after  # any header may be included


def test_library_path_follows_source(csrc_copy):
    before = cuda_build.library_path("shade_backward")
    other = cuda_build.library_path("raster_shade_row")
    src = csrc_copy / "shade_backward.cu"
    src.write_text(src.read_text() + "\n")
    assert cuda_build.library_path("shade_backward") != before
    assert cuda_build.library_path("raster_shade_row") == other  # another source's edit


def test_shipped_sources_include_the_shared_shader():
    for name in ("raster_shade_row.cu", "shade_backward.cu", "shade_forward.cu"):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            assert '#include "shade_core.cuh"' in f.read()
