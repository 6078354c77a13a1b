"""Structured timing + profiling hooks.

The reference times with ad-hoc ``time.time()`` spans (ai_tools.py:152-155,
synthetic_datasets_generator.py:322,342) and surfaces two numbers in its JSON
answer. Here timing is a first-class module: nested spans collected into a
dict. Every pipeline stage ends by copying its result to the host, which
waits for the device, so a span covers the stage's device work.
``device_trace`` is the counterpart of eitx.core.timing.device_trace on
``torch.profiler``; ``call_ms`` times a call on the card or the CPU for the
profiling scripts.

The program's own spans and counters (``span``, ``count``) mark the
boundaries of its layers: the FEM call's stages (``eitx.fem.*``), the train
step's phases (``eitx.train.*``) and the pipeline's stages
(``eitx.pipeline.*``). They record only while a ``torch.profiler`` records;
otherwise each costs one check of the profiler's state. While one records,
a span is a ``record_function`` range on the profiler's clock, so the trace
shows it above the kernels it launched, and it adds its calls and host
seconds (and, for a span given a CUDA device, the device seconds between
two CUDA events on that device's stream) to a table of the process, read by
``recorded()``. No span waits for the device or changes what it encloses.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("eitx_torch")


@dataclass
class _Record:
    """What the spans of one name added up to."""

    calls: int = 0
    host_s: float = 0.0
    device_s: Optional[float] = None  # None until a span times the card
    pending: list = field(default_factory=list)  # (start, end) events

    def fold(self, wait: bool) -> None:
        """Adds the device time of the pending event pairs that have ended
        (of all of them, waiting, with ``wait``) to ``device_s``."""
        while self.pending and (wait or self.pending[0][1].query()):
            a, b = self.pending.pop(0)
            b.synchronize()
            self.device_s += a.elapsed_time(b) / 1e3


_lock = threading.Lock()
_spans: Dict[str, _Record] = {}
_counters: Dict[str, float] = {}
# the span while no profiler records: enters nothing
_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span: a profiler range, the host clock and, on a card,
    two CUDA events on the stream the enclosed work is queued on."""

    __slots__ = ("name", "stream", "_range", "_start", "_t0")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if self.stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self.stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self._t0
        pair = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            pair = (self._start, end)
        self._range.__exit__(*exc)
        with _lock:
            rec = _spans.setdefault(self.name, _Record())
            rec.calls += 1
            rec.host_s += host
            if pair is not None:
                rec.device_s = rec.device_s or 0.0
                rec.pending.append(pair)
                rec.fold(wait=False)
        return False


def span(name: str, device=None):
    """A span of the program named ``name``. While no profiler records it
    does nothing; while one records it opens a profiler range and adds its
    calls and host seconds to the table, and, when ``device`` is a CUDA
    device, the device seconds of the work queued inside it on that
    device's current stream."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    return _Span(name, stream)


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    if not torch.autograd._profiler_enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def recorded() -> Tuple[Dict[str, dict], Dict[str, float]]:
    """(spans, counters) recorded so far: ``{name: {"calls", "host_s",
    "device_s"}}`` (``device_s`` None for a span that timed no device
    work) and ``{name: total}``. Waits for the end events of the device
    spans still running."""
    with _lock:
        spans = {}
        for name, rec in _spans.items():
            rec.fold(wait=True)
            spans[name] = {"calls": rec.calls, "host_s": rec.host_s,
                           "device_s": rec.device_s}
        return spans, dict(_counters)


def clear() -> None:
    """Empties the table of spans and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


class Timer:
    """Collects named wall-clock spans; nested use is additive per name.
    Each is also the program's span ``eitx.pipeline.<name>``."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"eitx.pipeline.{name}"):
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
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the enclosed block (host and, where a
    card is present, its kernels) written to ``logdir`` as a TensorBoard
    trace, with the program's spans as ranges on the kernels' timeline;
    does nothing when ``logdir`` is None."""
    if logdir is None:
        yield
        return
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
