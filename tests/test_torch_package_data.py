"""The installed port can build its kernels: every source and header that
``_build`` compiles and hashes (``csrc/*.cu*``) is shipped as package data
by ``pyproject.toml``, so a non-editable install holds what nvcc needs."""

import fnmatch
import tomllib
from pathlib import Path

import pytest

_build = pytest.importorskip("audio_matcher_tpu_torch._build")

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "audio_matcher_tpu_torch"


def _package_data_globs():
    with open(REPO / "pyproject.toml", "rb") as f:
        conf = tomllib.load(f)
    return conf["tool"]["setuptools"]["package-data"][
        "audio_matcher_tpu_torch"]


def test_every_hashed_source_is_package_data():
    globs = _package_data_globs()
    sources = _build.hashed_sources()
    assert any(s.suffix == ".cuh" for s in sources)
    for src in sources:
        rel = src.relative_to(PACKAGE).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_compiled_sources_are_among_the_hashed_ones():
    """nvcc compiles ``csrc/*.cu``; the headers they include are hashed
    beside them, and the library's name changes with any of their bytes."""
    hashed = set(_build.hashed_sources())
    assert set(_build.sources()) <= hashed
    for src in _build.sources():
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                header = src.parent / line.split('"')[1]
                assert header in hashed, header
