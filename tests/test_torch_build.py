"""The port's kernel build (lightgbm_tpu_torch/_build.py) on the CPU: the
library's name is a digest of every file a build reads, so that an edited
source or header builds a new library.  Nothing here runs nvcc."""
from lightgbm_tpu_torch import _build


def test_digest_covers_sources_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int kX = 1;\n")
    (tmp_path / "notes.txt").write_text("not read by a build\n")
    assert [p.name for p in _build._sources()] == ["a.cu"]
    assert [p.name for p in _build._inputs()] == ["a.cu", "common.cuh"]
    before = _build._digest(_build._inputs())
    (tmp_path / "notes.txt").write_text("edited\n")
    assert _build._digest(_build._inputs()) == before
    (tmp_path / "common.cuh").write_text("constexpr int kX = 2;\n")
    after = _build._digest(_build._inputs())
    assert after != before
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._digest(_build._inputs()) not in (before, after)


def test_package_sources_are_the_kernels():
    """The sources the build compiles: B5's one-scan kernel, one file for
    the dense wave histogram kernels (B1, B3, B4, and B5 past what a
    cluster holds) beside those of B2 and B6, and the fixed-point header
    the three histogram sources share."""
    assert [p.name for p in _build._sources()] == [
        "leaf_hist.cu", "score_update.cu", "sparse_hist.cu",
        "wave_fused.cu"]
    assert "fixed_point.cuh" in [p.name for p in _build._inputs()]
