"""Structured timing + profiling hooks.

The reference times with ad-hoc ``time.time()`` spans (ai_tools.py:152-155,
synthetic_datasets_generator.py:322,342) and surfaces two numbers in its JSON
answer. Here timing is a first-class module: nested spans collected into a
dict. Every pipeline stage ends by copying its result to the host, which
waits for the device, so a span covers the stage's device work.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

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
