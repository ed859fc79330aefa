"""resident: inputs already on the card, calls back to back, outputs left
on the card.  At most ``IN_FLIGHT`` calls are queued on the card at a
time, so that the host cannot run ahead of the window."""

import time
from collections import deque

import torch

from stereo_bench.drive import Window
from stereo_bench.trace import span

IN_FLIGHT = 2


def inputs(lefts, rights, device):
    """What the window cycles through: the pool as (pool, B, H, W) uint8
    tensors on the device."""
    return torch.from_numpy(lefts).to(device), torch.from_numpy(rights).to(device)


def call(engine, left, right):
    """One call as the window makes it, with its output as the window
    keeps it."""
    return engine.match_batch(left, right)


def window(engine, lefts, rights, seconds: float, clock, sample,
           traced: bool = False) -> Window:
    """Batches already on the card back to back."""
    pending, host_calls, n = deque(), [], 0
    clock.sync()
    t0 = time.perf_counter()
    start = clock.mark()
    with span("window", traced):
        while True:
            k = n % len(lefts)
            h0 = time.perf_counter()
            with span("match_batch", traced):
                out = engine.match_batch(lefts[k], rights[k])
            host_calls.append(time.perf_counter() - h0)
            sample.offer(k, out)
            pending.append(clock.mark())
            n += 1
            if len(pending) >= IN_FLIGHT:
                with span("wait", traced):
                    clock.wait(pending.popleft())
            if time.perf_counter() - t0 >= seconds:
                break
        end = clock.mark()
        with span("drain", traced):
            clock.sync()
    elapsed = time.perf_counter() - t0
    return Window(n, elapsed, clock.ms(start, end), [], host_calls)
