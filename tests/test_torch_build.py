"""The kernel build's cache key, on the CPU (nothing is compiled here).

``_build.library_path`` names the library a source builds to by a hash of
the ``.cu`` file, every ``csrc`` header it includes (through other headers
too) and the compiler flags, so an edited header never loads a library
built before the edit.
"""

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n'
        '// #include "commented.cuh" is no include\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "unused.cuh").write_text("int u;\n")
    return tmp_path


def test_sources_follow_includes(csrc):
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh",
                                                      "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_any_included_file_changes_the_library_path(csrc, edited):
    before = _build.library_path("k")
    assert before.parent == csrc / "build" and before.name.startswith("k-")
    path = csrc / edited
    path.write_bytes(path.read_bytes() + b"// edited\n")
    assert _build.library_path("k") != before


def test_unincluded_header_does_not_change_the_library_path(csrc):
    before = _build.library_path("k")
    (csrc / "unused.cuh").write_text("int u2;\n")
    assert _build.library_path("k") == before


def test_real_kernels_hash_the_shared_header():
    names = {p.name for p in _build.sources("moe_gmm")}
    assert names == {"moe_gmm.cu", "mma_bf16.cuh"}
    assert {p.name for p in _build.sources("flash_attention")} == {
        "flash_attention.cu", "mma_bf16.cuh"}
