"""The kernel build's cache key: a library is named by a hash of its
source, of every header in `csrc/` and of the flags, so an edit to any
of them builds anew and a stale library is never loaded."""

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu_torch.ops import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
  monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
  (tmp_path / "kern.cu").write_text('#include "tiles.cuh"\n// v1\n')
  (tmp_path / "tiles.cuh").write_text("// v1\n")
  return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_library_path_changes_with_every_input(csrc, edit):
  before = build.library_path("kern")
  assert build.library_path("kern") == before
  if edit == "source":
    (csrc / "kern.cu").write_text('#include "tiles.cuh"\n// v2\n')
  elif edit == "header":
    (csrc / "tiles.cuh").write_text("// v2\n")
  else:
    (csrc / "more.cuh").write_text("// v1\n")
  after = build.library_path("kern")
  assert after != before
  assert after.parent == build.BUILD_DIR and after.name.startswith("libkern-")


def test_every_kernel_source_has_a_library_path():
  for source in sorted(build.CSRC_DIR.glob("*.cu")):
    assert build.library_path(source.stem).suffix == ".so"
