"""The kernel library's cache key (lamp_tpu_torch.ops._build.source_key)
covers every file under csrc/: an edit to any source or header, or a new
file, gives a new key, so that a stale library is never loaded. Needs no
compiler: the key is a hash of the files."""

import shutil

import pytest

from lamp_tpu_torch.ops import _build

FILES = sorted(p.name for p in _build._SRC_DIR.iterdir() if p.is_file())


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(_build._SRC_DIR, tmp_path / "csrc")


def test_the_tree_has_a_header_and_sources():
    assert any(f.endswith(".cuh") for f in FILES)
    assert sum(f.endswith(".cu") for f in FILES) >= 6


def test_the_key_is_stable(csrc):
    assert _build.source_key(csrc) == _build.source_key(csrc)
    assert _build.source_key(csrc) == _build.source_key()


@pytest.mark.parametrize("name", FILES)
def test_an_edit_to_any_file_changes_the_key(csrc, name):
    before = _build.source_key(csrc)
    path = csrc / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build.source_key(csrc) != before


def test_a_new_header_changes_the_key(csrc):
    before = _build.source_key(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_key(csrc) != before
