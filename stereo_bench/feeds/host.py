"""host: a camera.  Each call takes a uint8 numpy pair from host memory
into ``match_batch`` and brings its float32 disparity back to host memory
(``.cpu()``, which waits for it) before the next frame goes in.  Each
frame is timed between two marks of the clock: one before the call, one
after its disparity is in host memory."""

import time

from stereo_bench.drive import Window
from stereo_bench.trace import span


def inputs(lefts, rights, device):
    """What the window cycles through: the numpy pool as it is."""
    return lefts, rights


def call(engine, left, right):
    """One call as the window makes it, with its output as the window
    keeps it."""
    return engine.match_batch(left, right).cpu().numpy()


def window(engine, lefts, rights, seconds: float, clock, sample,
           traced: bool = False) -> Window:
    """Frames from host memory (numpy (pool, 1, H, W)) through
    ``match_batch`` and back, one at a time."""
    marks, host_calls, n = [], [], 0
    clock.sync()
    t0 = time.perf_counter()
    start = clock.mark()
    with span("window", traced):
        while True:
            k = n % len(lefts)
            a = clock.mark()
            h0 = time.perf_counter()
            with span("match_batch", traced):
                out = engine.match_batch(lefts[k], rights[k])
            host_calls.append(time.perf_counter() - h0)
            with span("download", traced):
                disp = out.cpu().numpy()
            marks.append((a, clock.mark()))
            sample.offer(k, disp)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
    elapsed = time.perf_counter() - t0
    end = clock.mark()
    clock.sync()
    return Window(n, elapsed, clock.ms(start, end),
                  [clock.ms(a, b) for a, b in marks], host_calls)
