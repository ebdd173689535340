"""Device time of a call on the card, read from CUDA events.

`loop_ms` times a plain loop of calls, as a caller without a graph sees it;
`graph_ms` replays the calls from one CUDA graph, so that the host's time
between launches (about 30-50 us a wrapper call) cannot pace a kernel
shorter than it. `chip_smoke.py` and the split scripts under `tests/perf/`
time with these; nothing on the model's path uses them.
"""
from __future__ import annotations

from typing import Callable

import torch


def loop_ms(fn: Callable, iters: int = 50, warmup: int = 5) -> float:
    """ms a call of `fn` takes: the mean of `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, iters: int = 50, replays: int = 5) -> float:
    """ms a call of `fn` takes on the card alone: `iters` calls captured in one
    CUDA graph, the mean over `replays` replays of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)
