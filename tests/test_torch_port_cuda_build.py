"""PyTorch port (simseg_tpu_torch): the kernel build's library names. No
nvcc is needed: the digest that names a library is computed from the
sources alone, and a build that would be needed is caught before nvcc."""

import hashlib
import os
import shutil

import pytest

from simseg_tpu_torch.ops import cuda_build

_KERNELS = ("crf_mean_field", "crf_mean_field_bf16", "flash_attention",
            "flash_attention_bwd", "bilateral_matvec")


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture
def csrc(tmp_path):
    """a.cu includes h.cuh (which includes g.cuh) and a system header;
    b.cu and other.cuh are unrelated to it."""
    _write(tmp_path / "a.cu", '#include <cuda.h>\n#include "h.cuh"\nint a;\n')
    _write(tmp_path / "h.cuh", '#pragma once\n#include "g.cuh"\nint h;\n')
    _write(tmp_path / "g.cuh", "int g;\n")
    _write(tmp_path / "b.cu", "int b;\n")
    _write(tmp_path / "other.cuh", "int other;\n")
    return tmp_path


@pytest.mark.parametrize("edited,changes", [
    ("a.cu", True), ("h.cuh", True), ("g.cuh", True), ("b.cu", False),
    ("other.cuh", False)])
def test_digest_follows_the_headers_a_source_includes(csrc, edited, changes):
    before = cuda_build.source_digest("a", str(csrc))
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (cuda_build.source_digest("a", str(csrc)) != before) == changes


def test_digest_of_a_source_without_headers_is_its_hash(csrc):
    want = hashlib.sha256((csrc / "b.cu").read_bytes()).hexdigest()[:12]
    assert cuda_build.source_digest("b", str(csrc)) == want


def test_digest_needs_the_source(csrc):
    with pytest.raises(FileNotFoundError):
        cuda_build.source_digest("missing", str(csrc))


def test_an_edited_header_builds_a_new_library(csrc, tmp_path, monkeypatch):
    """A library built for a.cu is found as long as its header is unchanged;
    after an edit to the header the build runs again (here: reaches nvcc,
    which is stubbed to fail)."""
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))

    def no_nvcc():
        raise RuntimeError("nvcc reached")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    built = build / f"liba-{cuda_build.source_digest('a', str(csrc))}.so"
    built.write_bytes(b"")
    assert cuda_build.build_library("a") == str(built)
    with open(csrc / "g.cuh", "a") as f:
        f.write("int g2;\n")
    with pytest.raises(RuntimeError, match="nvcc reached"):
        cuda_build.build_library("a")


@pytest.mark.parametrize("name", _KERNELS)
def test_the_port_kernels_hash_the_shared_header(tmp_path, name):
    """The attention sources include csrc/hopper_sm90.cuh, so an edit to it
    renames their libraries and leaves the CRF sources' names alone."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    before = cuda_build.source_digest(name, str(copy))
    assert before == cuda_build.source_digest(name)
    with open(os.path.join(copy, "hopper_sm90.cuh"), "a") as f:
        f.write("// edited\n")
    changed = cuda_build.source_digest(name, str(copy)) != before
    assert changed == name.startswith("flash_attention")


@pytest.mark.parametrize("name", _KERNELS)
def test_the_crf_sources_hash_their_shared_header(tmp_path, name):
    """Both CRF sources (float32 and bf16) include csrc/crf_common.cuh, so
    an edit to it renames both their libraries and no other."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    before = cuda_build.source_digest(name, str(copy))
    with open(os.path.join(copy, "crf_common.cuh"), "a") as f:
        f.write("// edited\n")
    changed = cuda_build.source_digest(name, str(copy)) != before
    assert changed == name.startswith("crf_mean_field")
