"""The port's build cache (`ops/kernels/_build.py`), on the CPU: no nvcc.

A library's name carries a hash of its source and of every header in
`csrc/`, so an edited header can never leave a stale library in use.
"""

import shutil

import pytest

from equiadapt_tpu_torch.ops.kernels import _build
from torch_port_cpu import one_intra_op_thread  # noqa: F401


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A temporary copy of `csrc/`, made the build's source directory."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_every_source_and_header_is_in_the_tree():
    names = {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    assert names == set(_build.SOURCES)
    assert (_build.CSRC_DIR / "quarter_turn.cuh").exists()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_target_is_stable_for_the_same_files(name, csrc_copy):
    first = _build._target(name)
    assert first == _build._target(name)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith(f"lib{name}_") and first.suffix == ".so"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_target_changes_with_a_header(name, csrc_copy):
    before = _build._target(name)
    header = csrc_copy / "quarter_turn.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target(name) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_target_changes_with_a_new_header(name, csrc_copy):
    before = _build._target(name)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._target(name) != before


def test_target_changes_with_its_source_only(csrc_copy):
    before = {n: _build._target(n) for n in _build.SOURCES}
    src = csrc_copy / "knn.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert after["knn"] != before["knn"]
    assert all(after[n] == before[n] for n in _build.SOURCES if n != "knn")


def test_build_log_is_kept_and_read_back(csrc_copy, tmp_path, monkeypatch):
    """A library built in an earlier process keeps its compiler output
    beside it, so `build_logs` (the ptxas report) is there without a
    rebuild. nvcc is a stand-in script that writes the output file."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\n'
                    'while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done\n'
                    'echo "ptxas info    : 0 bytes stack frame"; : > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build_all(("select_warp",))
    target = _build._target("select_warp")
    assert target.exists() and "stack frame" in target.with_suffix(".log").read_text()
    monkeypatch.setattr(_build, "build_logs", {})
    _build.build_all(("select_warp",))  # built already: no nvcc, the log read back
    assert "stack frame" in _build.build_logs["select_warp"]
