"""Readings of a ``torch.profiler`` trace of the traced window.

``busy_us`` is ``bench_torch.py`` ``_busy_ms`` (lines 217-227), the union
of the device's kernel and copy intervals, kept in microseconds; the top
operations follow ``bench_torch.py`` ``profiled`` (lines 230-262), which
also refuses a trace with no device time. Idle gaps are the spaces
between the device's busy intervals inside the window, each named by
what the host was doing at its middle: the innermost span or operator
that covers it.
"""

from __future__ import annotations

import collections
import heapq

import torch

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
TOP = 10


class Trace:
    """The device intervals, host events and named ranges of one
    profiler run."""

    def __init__(self, prof):
        events = prof.events()
        # kernels and copies; a range the benchmark opened shows on the
        # device's timeline too (a user annotation), and is left out
        self.device = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))
        self.host = [(e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == CPU
                     and e.time_range.end > e.time_range.start]
        self.range_device_us = collections.defaultdict(float)
        for e in events:
            if e.device_type == CPU and e.name.startswith("bench."):
                self.range_device_us[e.name] += e.device_time_total

    def busy_intervals(self):
        """The union of the device intervals, as merged (start, end)."""
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def kernel_us(self, match) -> float:
        """Summed duration of the device operations whose name ``match``
        accepts."""
        return float(sum(b - a for a, b, n in self.device if match(n)))

    def top_ops(self, k: int = TOP):
        ops = collections.defaultdict(float)
        for a, b, n in self.device:
            ops[n] += b - a
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], us / 1e6] for n, us in top]

    def idle_gaps(self, k: int = TOP):
        """Idle seconds between busy intervals, summed by what the host
        was doing at each gap's middle (the shortest host event that
        covers it), the largest ``k``."""
        busy = self.busy_intervals()
        mids = sorted((0.5 * (s + e), s - e)
                      for (_, e), (s, _) in zip(busy, busy[1:]) if s > e)
        hosts = sorted(self.host)
        gaps = collections.defaultdict(float)
        live, i = [], 0  # heap of (duration, index) of started events
        for t, length in mids:
            while i < len(hosts) and hosts[i][0] <= t:
                heapq.heappush(live, (hosts[i][1] - hosts[i][0], i))
                i += 1
            while live and hosts[live[0][1]][1] < t:  # ended: gone for good
                heapq.heappop(live)
            gaps[hosts[live[0][1]][2] if live else "no host event"] += length
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], us / 1e6] for n, us in top]


def profile(host_ops: bool = True):
    """A profiler of the card and, with ``host_ops``, of the host's
    operators and the benchmark's ranges; nothing recorded beyond the
    events (no shapes, stacks or memory). Recording every host operator
    costs a launch-bound path (a training step's ~3,100 launches) more
    than half its speed, so such a cell traces the card alone."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops or not torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)
