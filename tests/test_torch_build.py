"""The kernel build's cache key (``repro_torch.kernels.build``), on the CPU:
no nvcc is needed. A library's name carries a digest of its ``.cu`` source,
of every shared ``csrc/*.cuh`` header and of the flags, so an edited header
rebuilds every kernel; a header is never a build target of its own."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "alpha.cu").write_text('#include "tile.cuh"\nextern "C" int f() { return 0; }\n')
    (src / "beta.cu").write_text('extern "C" int g() { return 1; }\n')
    (src / "tile.cuh").write_text("#pragma once\nconstexpr int kBK = 32;\n")
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return src


def test_library_path_changes_with_a_header(csrc):
    before = {n: build.library_path(n) for n in ("alpha", "beta")}
    assert build.library_path("alpha") == before["alpha"]  # deterministic
    (csrc / "tile.cuh").write_text("#pragma once\nconstexpr int kBK = 16;\n")
    after = {n: build.library_path(n) for n in ("alpha", "beta")}
    assert all(after[n] != before[n] for n in after)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("alpha") != after["alpha"]


def test_library_path_changes_with_the_source_only_for_its_kernel(csrc):
    alpha, beta = build.library_path("alpha"), build.library_path("beta")
    (csrc / "beta.cu").write_text('extern "C" int g() { return 2; }\n')
    assert build.library_path("alpha") == alpha
    assert build.library_path("beta") != beta
    assert beta.parent == build.BUILD_DIR and beta.name.startswith("beta-")


def test_a_header_is_never_a_build_target(csrc):
    assert build.kernel_names() == ["alpha", "beta"]
    # every target already built: build_all starts no nvcc, and would fail
    # (no fp32 header source) if it took the header for a target
    build.BUILD_DIR.mkdir()
    for name in build.kernel_names():
        build.library_path(name).write_bytes(b"")
    assert build.build_all() >= 0.0
