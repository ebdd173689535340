"""The edits of tests/perf/talking_heads_kernels_cuda.py still find their kernels.

That script times edited copies of the talking-heads kernels on the card:
of the backward (`nowgrad` skips the warp-row kernel's weight-gradient
products, `nomem` its streaming past each warp's first row, `block` sends
every shape to the block-row kernel) and of the forward (`fwdnomem` has each
warp of the warp-row kernel load and store only its first row, `fwdblock`
sends every shape to the block-row kernel). Each edit replaces an anchor in
`passl_tpu_torch/csrc/talking_heads_bwd.cu` or `talking_heads.cu`; an edit
to a kernel that moves its anchor would silently leave the kernel whole.
These tests read the sources on the CPU and check that every anchor still
lies in the kernel its edit names, and nowhere else.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "passl_tpu_torch" / "csrc"
SCRIPT = REPO / "tests" / "perf" / "talking_heads_kernels_cuda.py"
KERNELS = {"talking_heads_bwd_kernel", "talking_heads_bwd_row_kernel", "talking_heads_wgrad_reduce"}
FWD_KERNELS = {"talking_heads_fwd_kernel", "talking_heads_fwd_row_kernel"}


def _script():
    spec = importlib.util.spec_from_file_location("talking_heads_kernels_cuda", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EDITS = _script().EDITS
CASES = [(name, i) for name, edits in EDITS.items() for i in range(len(edits))]


def _kernel_spans(code: str) -> list[tuple[str, int, int]]:
    """(name, start, end) of every __global__ function's body in `code`."""
    spans = []
    for match in re.finditer(r"__global__ void[^\n]*\n(\w+)\(", code):
        start = code.index("{", match.end())
        depth, pos = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(code[pos], 0)
            if depth == 0:
                break
            pos += 1
        spans.append((match.group(1), start, pos))
    return spans


def _holders(code: str, anchor: str) -> list:
    """For each occurrence of `anchor`, the kernel whose body holds it (None at file scope)."""
    spans = _kernel_spans(code)
    return [next((name for name, a, b in spans if a < m.start() < b), None)
            for m in re.finditer(re.escape(anchor), code)]


@pytest.mark.parametrize("name, index", CASES)
def test_every_anchor_lies_in_the_kernel_its_edit_names(name, index):
    source, anchor, replacement, kernels = EDITS[name][index]
    assert replacement != anchor
    holders = _holders((CSRC / source).read_text(), anchor)
    assert holders, f"{name}: {source} has no {anchor!r}"
    if kernels:
        assert set(holders) == set(kernels), (name, source, holders)
    else:  # a file-scope line: exactly one, in no kernel's body
        assert holders == [None], (name, source, holders)


@pytest.mark.parametrize("name, count", [("nowgrad", 2), ("nomem", 1), ("fwdnomem", 1)])
def test_each_split_edit_hits_every_call_it_means(name, count):
    """nowgrad: both products (dww and dwl); nomem: the one staging call;
    fwdnomem: the one offset of the next row."""
    source, anchor, _, _ = EDITS[name][0]
    assert (CSRC / source).read_text().count(anchor) == count


def test_kernel_spans_find_the_talking_heads_backward_kernels():
    names = {n for n, _, _ in _kernel_spans((CSRC / "talking_heads_bwd.cu").read_text())}
    assert names == KERNELS


def test_kernel_spans_find_the_talking_heads_forward_kernels():
    names = {n for n, _, _ in _kernel_spans((CSRC / "talking_heads.cu").read_text())}
    assert names == FWD_KERNELS


def test_forward_copies_touch_only_the_forward():
    """fwdblock and fwdnomem edit talking_heads.cu alone, so the backward in
    their runs is the checkout's."""
    for name in ("fwdblock", "fwdnomem"):
        assert {source for source, *_ in EDITS[name]} == {"talking_heads.cu"}
