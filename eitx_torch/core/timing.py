"""Structured timing + profiling hooks.

The reference times with ad-hoc ``time.time()`` spans (ai_tools.py:152-155,
synthetic_datasets_generator.py:322,342) and surfaces two numbers in its JSON
answer. Here timing is a first-class module: nested spans collected into a
dict. Every pipeline stage ends by copying its result to the host, which
waits for the device, so a span covers the stage's device work.
``device_trace`` is the counterpart of eitx.core.timing.device_trace on
``torch.profiler``; ``call_ms`` times a call on the card or the CPU for the
profiling scripts.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("eitx_torch")


class Timer:
    """Collects named wall-clock spans; nested use is additive per name."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            logger.debug("span %s: %.4fs", name, dt)

    def get(self, name: str, default: float = 0.0) -> float:
        return self.spans.get(name, default)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.spans)


@contextlib.contextmanager
def timed(name: str, timer: Optional[Timer] = None):
    """Span against an explicit Timer or a throwaway one."""
    t = timer if timer is not None else Timer()
    with t.span(name):
        yield t


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the enclosed block (host and, where a
    card is present, its kernels) written to ``logdir`` as a TensorBoard
    trace; does nothing when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield


def call_ms(fn, *args, repeats: int = 5, device="cuda") -> List[float]:
    """ms of each of ``repeats`` calls of ``fn(*args)`` after one warm-up
    call: between two CUDA events on the card, by the host's clock up to
    the call's return on the CPU."""
    fn(*args)
    times = []
    for _ in range(repeats):
        if torch.device(device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(1e3 * (time.perf_counter() - t0))
    return times
