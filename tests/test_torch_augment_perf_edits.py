"""The edits of tests/perf/augment_kernels_cuda.py still find their kernel.

That script times edited copies of `passl_tpu_torch/csrc/augment.cu` on the
card: `nomem` has every block of the fast kernel read and write image 0's
band, `novert` and `nohorz` skip one of its two FFMA nests, `first` sends
every shape to the generic kernel. An edit to the kernel that moves its
anchor would silently leave the kernel whole. These tests read the source on
the CPU and check that every anchor still lies in the kernel its edit names,
and nowhere else, with the span helper of the talking-heads script's tests.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "passl_tpu_torch" / "csrc" / "augment.cu"


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SPANS = _module("talking_heads_perf_edits", REPO / "tests" / "test_torch_talking_heads_perf_edits.py")
SCRIPT = _module("augment_kernels_cuda", REPO / "tests" / "perf" / "augment_kernels_cuda.py")
EDITS = SCRIPT.EDITS
CASES = [(name, i) for name, edits in EDITS.items() for i in range(len(edits))]


@pytest.mark.parametrize("name, index", CASES)
def test_every_anchor_lies_in_the_kernel_its_edit_names(name, index):
    source, anchor, replacement, kernels = EDITS[name][index]
    assert source == SOURCE.name and replacement != anchor
    holders = SPANS._holders(SOURCE.read_text(), anchor)
    assert holders, f"{name}: {source} has no {anchor!r}"
    if kernels:
        assert set(holders) == set(kernels), (name, holders)
    else:  # a file-scope line: exactly one, in no kernel's body
        assert holders == [None], (name, holders)


@pytest.mark.parametrize("name", ["nomem", "novert", "nohorz"])
def test_each_split_edit_hits_one_line(name):
    """nomem: the one image offset; novert, nohorz: the one call of each nest."""
    (_, anchor, _, _), = EDITS[name]
    assert SOURCE.read_text().count(anchor) == 1


def test_kernel_spans_find_both_augment_kernels():
    names = {n for n, _, _ in SPANS._kernel_spans(SOURCE.read_text())}
    assert names == {"augment_generic_kernel", "augment_fast_kernel"}


def test_sass_kernel_names_a_compiled_instance():
    """--sass reads the fast kernel at BYOL's radius and channels, which the
    C dispatch compiles (radius 11, C 3)."""
    code = SOURCE.read_text()
    assert SCRIPT.SASS_KERNEL == "augment_fast_kernelILi11ELi3EE"
    assert "case 11: return fast_rc<11, C>" in code and "case 3: return fast_c<3>" in code
