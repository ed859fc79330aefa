"""What every measured loop shares: the clocks, the record of a window,
and the sample of outputs whose correctness is checked after the window.

The loops themselves are the feeds (``feeds/<feed>.py``, the ``feed`` of a
traffic file).  Each is one client in a closed loop: the next call goes in
as soon as the loop lets it, and the window closes at the first completion
past ``seconds``.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, NamedTuple


class CardClock:
    """CUDA events on the current stream; times read after a synchronise."""

    def __init__(self, torch):
        self._torch = torch

    def mark(self):
        event = self._torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    @staticmethod
    def wait(mark) -> None:
        mark.synchronize()

    def sync(self) -> None:
        self._torch.cuda.synchronize()


class HostClock:
    """The host's clock, for runs on the CPU (the tests): every call there
    has finished when it returns."""

    mark = staticmethod(time.perf_counter)

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3

    @staticmethod
    def wait(mark) -> None:
        pass

    def sync(self) -> None:
        pass


class Sample:
    """``keep`` outputs of each of ``pool`` entries, drawn from ``seed``:
    a reservoir per pool entry over all the calls on that entry, so that
    every entry the window reached is checked."""

    def __init__(self, pool: int, keep: int, seed: int):
        self.size = pool * keep
        self.keep = keep
        self.rng = random.Random(seed)
        self.seen = [0] * pool
        self.kept: Dict[int, list] = {}

    def offer(self, index: int, out) -> None:
        self.seen[index] += 1
        kept = self.kept.setdefault(index, [])
        if len(kept) < self.keep:
            kept.append(out)
            return
        slot = self.rng.randrange(self.seen[index])
        if slot < self.keep:
            kept[slot] = out

    @property
    def items(self) -> List[tuple]:
        """[(pool index, output)], by pool index."""
        return [(k, out) for k in sorted(self.kept) for out in self.kept[k]]


class Window(NamedTuple):
    calls: int
    elapsed_s: float        # window start to the last completion, host clock
    window_ms: float        # the same between the clock's marks
    frame_ms: List[float]   # each call's time between its marks (host feed)
    host_call_s: List[float]  # each call's time inside match_batch, host clock
