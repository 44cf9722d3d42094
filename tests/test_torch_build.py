"""The cache key of the port's kernel build (``rayfed_tpu_torch/ops/_build.py``).

A built library is named by ``_source_digest(name)``, which must change
whenever its ``.cu`` source, any shared ``csrc/*.cuh`` header or the nvcc
flags change, so that an edited header never loads a stale library.  Runs
on the CPU: no nvcc is called.
"""

import pytest

from rayfed_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (src / "common.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_digest_is_stable(csrc):
    assert _build._source_digest("k") == _build._source_digest("k")


def test_digest_changes_with_the_source(csrc):
    before = _build._source_digest("k")
    (csrc / "k.cu").write_text('#include "common.cuh"\n__global__ void k(int) {}\n')
    assert _build._source_digest("k") != before


@pytest.mark.parametrize("edit", ["change", "add", "remove"])
def test_digest_changes_with_every_header(csrc, edit):
    before = _build._source_digest("k")
    if edit == "change":
        (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kTile = 128;\n")
    elif edit == "add":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        (csrc / "common.cuh").unlink()
    assert _build._source_digest("k") != before


def test_digest_ignores_other_sources(csrc):
    before = _build._source_digest("k")
    (csrc / "other.cu").write_text("__global__ void other() {}\n")
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build._source_digest("k") == before


def test_digest_changes_with_the_flags(csrc, monkeypatch):
    before = _build._source_digest("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build._source_digest("k") != before


def test_build_loads_no_stale_library_after_a_header_edit(csrc, monkeypatch):
    def no_nvcc():
        raise RuntimeError("would compile")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.BUILD_DIR.mkdir()
    built = _build.BUILD_DIR / f"libk-{_build._source_digest('k')}.so"
    built.write_bytes(b"")
    assert _build.build("k") == built  # up to date: no compile
    (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kTile = 32;\n")
    with pytest.raises(RuntimeError, match="would compile"):
        _build.build("k")


def test_repo_kernels_share_the_header_in_their_digests(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for path in (*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")):
        (src / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    names = sorted(p.stem for p in src.glob("*.cu"))
    headers = sorted(src.glob("*.cuh"))
    assert names and headers
    for header in headers:
        before = {n: _build._source_digest(n) for n in names}
        header.write_text(header.read_text() + "\n// edited\n")
        assert all(_build._source_digest(n) != before[n] for n in names), header.name
