"""The port's kernel build (``riptrm_torch/ops/_build.py``) on the CPU,
with a stand-in compiler: one compile per ``.cu`` and a link into a
library keyed by the sources (headers included), and a failed compile
that raises, names its source and leaves no library behind.  The real
``nvcc`` build runs on the card (``chip_smoke.py`` phase 1)."""

import os

import pytest

from riptrm_torch.ops import _build

# Writes the file after -o; fails on a source named bad.cu.
FAKE_NVCC = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  case "$a" in *bad.cu) echo "bad.cu: error"; exit 2;; esac
  prev="$a"
done
echo built > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text(name)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_build_links_every_source_once(fake_tree):
    path, _ = _build.build()
    assert path == _build.library_path() and os.path.isfile(path)
    assert _build.build() == (path, "")  # built already: nothing runs
    (fake_tree / "shared.cuh").write_text("changed")  # a header is part of the key
    assert _build.library_path() != path
    assert os.listdir(_build.BUILD_DIR) == [os.path.basename(path)]  # no scratch left


def test_build_failure_names_the_source(fake_tree):
    (fake_tree / "bad.cu").write_text("bad")
    with pytest.raises(RuntimeError, match=r"nvcc failed: bad\.cu \(2\)"):
        _build.build()
    assert not os.path.exists(_build.library_path())
    assert os.listdir(_build.BUILD_DIR) == []
