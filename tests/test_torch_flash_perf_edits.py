"""The edits of tests/perf/flash_kernels_cuda.py still find their kernels.

That script times edited copies of the flash kernels on the card (`nocomp`
skips the products, `nomem` the streaming beyond the first tile, `dq64`
takes the other dQ tile height). Each edit replaces an anchor in a source
under `passl_tpu_torch/csrc/`; an edit to a kernel that moves its anchor
would silently leave that kernel whole. These tests read the sources on the
CPU and check that every anchor still lies in the kernels its edit names,
and nowhere else.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "passl_tpu_torch" / "csrc"
SCRIPT = REPO / "tests" / "perf" / "flash_kernels_cuda.py"
TENSOR_CORE_KERNELS = {"flash_attention_fwd_mma_kernel", "flash_attention_dkv_mma_kernel",
                       "flash_attention_dq_mma_kernel"}


def _script():
    spec = importlib.util.spec_from_file_location("flash_kernels_cuda", SCRIPT)
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
def test_every_anchor_lies_in_the_kernels_its_edit_names(name, index):
    source, anchor, replacement, kernels = EDITS[name][index]
    assert replacement != anchor
    holders = _holders((CSRC / source).read_text(), anchor)
    assert holders, f"{name}: {source} has no {anchor!r}"
    if kernels:
        assert set(holders) == set(kernels), (name, source, holders)
    else:  # a file-scope constant: exactly one, in no kernel's body
        assert holders == [None], (name, source, holders)


@pytest.mark.parametrize("name", ["nocomp", "nomem"])
def test_each_split_edits_all_three_tensor_core_kernels(name):
    edited = {k for _, _, _, kernels in EDITS[name] for k in kernels}
    assert edited == TENSOR_CORE_KERNELS


def test_kernel_spans_find_the_flash_kernels():
    names = {n for src in ("flash_attention.cu", "flash_attention_bwd.cu")
             for n, _, _ in _kernel_spans((CSRC / src).read_text())}
    assert TENSOR_CORE_KERNELS <= names
