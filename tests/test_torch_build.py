"""The card libraries' names hash what a card build of each source reads.

``ops/_build.py:library_path`` names ``build/kernels/lib<name>-<hash>.so``
after the source, the headers of ``csrc/`` it includes (transitively) and
nvcc's flags.  An edit to a header rebuilds only the libraries that include
it, and an edit to ``host_emulation.h``, which only the host emulation
reads, rebuilds none.  Checked on a copy of ``csrc/``; nothing is compiled.
"""
import shutil

import pytest

from ssar_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths(csrc):
    return {p.stem: _build.library_path(p.stem) for p in csrc.glob("*.cu")}


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


def test_card_sources(csrc):
    assert [p.name for p in _build.card_sources("sliding_median")] == ["sliding_median.cu", "median_common.cuh"]
    assert [p.name for p in _build.card_sources("sliding_median_bwd")] == ["sliding_median_bwd.cu",
                                                                             "median_common.cuh"]
    for name in ("absdiff", "s4d_vandermonde"):
        assert [p.name for p in _build.card_sources(name)] == [f"{name}.cu"]


def test_host_emulation_header_changes_no_library(csrc):
    before = _paths(csrc)
    assert set(before) == {"absdiff", "s4d_vandermonde", "sliding_median", "sliding_median_bwd"}
    _append(csrc / "host_emulation.h")
    assert _paths(csrc) == before


def test_a_header_changes_the_libraries_that_include_it(csrc):
    before = _paths(csrc)
    _append(csrc / "median_common.cuh")
    after = _paths(csrc)
    assert {name for name in before if after[name] != before[name]} == {"sliding_median", "sliding_median_bwd"}
    _append(csrc / "absdiff.cu")
    assert {name for name in after if _paths(csrc)[name] != after[name]} == {"absdiff"}


def test_a_nested_include_is_followed(csrc):
    _append(csrc / "median_common.cuh", '\n#include "nested.cuh"\n')
    (csrc / "nested.cuh").write_text("// one\n")
    before = _paths(csrc)
    (csrc / "nested.cuh").write_text("// two\n")
    after = _paths(csrc)
    assert {name for name in before if after[name] != before[name]} == {"sliding_median", "sliding_median_bwd"}
