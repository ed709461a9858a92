"""The kernel build's cache key (`_build.Kernel.library_path`): a library is
named by a hash of its source and of every `csrc/` header the source
includes, so an edit to a shared header (`hopper_ptx.cuh`) never loads a
stale build. Checked on a temporary copy of `csrc/`; nothing is compiled."""

import shutil

import pytest

from nanorlhf_tpu_torch import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def _paths():
    kernels = {name: _build.Kernel(name, k.replaces, k.source_name)
               for name, k in _build.KERNELS.items()}
    return {name: k.library_path() for name, k in kernels.items()}


def test_flash_sources_include_the_shared_header():
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob"):
        closure = _build.source_closure(_build.KERNELS[name].source)
        assert [p.name for p in closure][1:] == ["hopper_ptx.cuh"], name
    assert [p.name for p in _build.source_closure(_build.KERNELS["decode_attention"].source)] \
        == ["decode_attention.cu"]


def test_header_edit_changes_the_library_path(csrc_copy):
    before = _paths()
    header = csrc_copy / "hopper_ptx.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = _paths()
    includers = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob"}
    for name in before:
        assert (after[name] != before[name]) == (name in includers), name
    # kernels of one source share one library
    assert after["flash_bwd_dq"] == after["flash_bwd_dkv"]


def test_source_edit_changes_only_its_own_library_path(csrc_copy):
    before = _paths()
    src = csrc_copy / "decode_attention.cu"
    src.write_text(src.read_text() + "\n// an edit\n")
    after = _paths()
    sharers = {n for n, k in _build.KERNELS.items() if k.source_name == "decode_attention"}
    for name in before:
        assert (after[name] != before[name]) == (name in sharers), name


def test_nested_includes_are_hashed_and_foreign_headers_are_not(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    (csrc_copy / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc_copy / "unused.cuh").write_text("#pragma once\n")
    src = csrc_copy / "fused_logprob.cu"
    src.write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n' + src.read_text())
    k = _build.Kernel("fused_logprob", "x")
    assert [p.name for p in _build.source_closure(k.source)] == [
        "fused_logprob.cu", "outer.cuh", "hopper_ptx.cuh", "inner.cuh"]
    first = k.library_path()
    (csrc_copy / "unused.cuh").write_text("#pragma once\n// changed\n")
    assert k.library_path() == first
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// changed\n")
    assert k.library_path() != first
