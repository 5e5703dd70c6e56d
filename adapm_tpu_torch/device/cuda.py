"""The port's CUDA seam: the stream, event, graph and device-setter APIs
of torch.cuda that code outside the device plane needs, in one place
(adapm-lint APM008 confines them to device/, ops/kernels.py,
parallel/exchange.py and tools/).

    event()              a CUDA event (the pinned upload rings' fences)
    stream_idle(dev)     whether the device's current stream has finished
                         all it was given (a non-blocking probe)
    synchronize(dev)     wait for the device
    set_device(dev)      make `dev` the current card
    warm_on_side_stream  run a function once on a side stream, as a graph
                         capture wants its first call made
    capture_graph        capture a function into a CUDA graph
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def event() -> "torch.cuda.Event":
    return torch.cuda.Event()


def stream_idle(dev: torch.device) -> bool:
    return torch.cuda.current_stream(dev).query()


def synchronize(dev: torch.device) -> None:
    torch.cuda.synchronize(dev)


def set_device(dev: torch.device) -> None:
    torch.cuda.set_device(dev)


def warm_on_side_stream(fn: Callable[[], torch.Tensor],
                        dev: torch.device) -> torch.Tensor:
    """fn() run on a fresh side stream ordered after the current one, the
    current stream then ordered after it; its result is kept alive for
    the current stream's use."""
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    out.record_stream(cur)
    return out


def capture_graph(fn: Callable[[], torch.Tensor]
                  ) -> Tuple["torch.cuda.CUDAGraph", torch.Tensor]:
    """(graph, fn()'s output as captured): the launches fn() makes are
    recorded, not run; graph.replay() runs them on the same buffers."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    return graph, out
