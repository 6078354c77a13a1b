"""Spans the benchmark puts around calls into the program's layers.

Adapted from ``chip_smoke.py`` ``stage_timer`` (lines 993-1024): while a
``Spans`` is open, every call of ``getattr(owner, name)`` for the targets
it was given is wrapped, and the attribute as stored is put back on
close. Unlike ``stage_timer`` the wrapper waits for nothing: it records
the host clock around the call (``kind="host"``), or two CUDA events
(``kind="device"``, read once the traced window has been synchronised),
and opens a profiler range of the span's name, so the kernels the call
launched can be told apart in the trace. No span is put inside the
program.
"""

from __future__ import annotations

import collections
import functools
import time

import torch

_CLASS = object()


class Spans:
    """Host and device spans by name: ``seconds(name)`` sums a span's
    durations, ``count(name)`` counts its calls."""

    def __init__(self, targets, device: torch.device):
        # targets: (owner, attribute, span name, "host" | "device")
        self.targets = list(targets)
        self.cuda = device.type == "cuda"
        self.host = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.events = collections.defaultdict(list)
        self._saved = []

    def _wrap(self, span: str, kind: str, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            self.calls[span] += 1
            with torch.profiler.record_function(span):
                if kind == "device" and self.cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = fn(*args, **kwargs)
                    b.record()
                    self.events[span].append((a, b))
                    return out
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.host[span] += time.perf_counter() - t0
                return out
        return wrapped

    def __enter__(self):
        for owner, name, span, kind in self.targets:
            # an instance's method lives on its class: put none back
            raw, bound = vars(owner).get(name, _CLASS), getattr(owner, name)
            self._saved.append((owner, name, raw))
            fn = self._wrap(span, kind, bound)
            setattr(owner, name, classmethod(lambda _c, *a, _f=fn, **k:
                                             _f(*a, **k))
                    if isinstance(raw, classmethod) else fn)
        return self

    def __exit__(self, *exc):
        for owner, name, raw in reversed(self._saved):
            if raw is _CLASS:
                delattr(owner, name)
            else:
                setattr(owner, name, raw)
        self._saved.clear()
        return False

    def seconds(self, span: str) -> float:
        """Total seconds of ``span``: host clock, or the device's time
        between each call's two events (after a synchronisation)."""
        if span in self.events:
            return sum(a.elapsed_time(b) for a, b in self.events[span]) / 1e3
        return self.host.get(span, 0.0)

    def count(self, span: str) -> int:
        return self.calls.get(span, 0)
