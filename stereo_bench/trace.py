"""The traced window: ``torch.profiler`` over the measured loop, reduced
to device operations by layer, the device's busy time and the idle gaps
by what the host was doing.

The benchmark marks its own host phases with ``record_function`` spans
named ``bench.<phase>``; the program is not instrumented.  A device
operation belongs to the layer whose patterns (``layers/<layer>/*.txt``)
its name matches, or to ``other``; a name that two layers claim is an
error, so that a pattern file added later cannot count a kernel twice.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

OTHER = "other"
HOST_PREFIX = "bench."
TOP = 10


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: List[Op]   # kernels, copies and sets the device ran
    host: List[Op]     # the benchmark's own bench.* spans


@contextlib.contextmanager
def span(name: str, on: bool):
    """A ``bench.<name>`` host span in the trace where ``on``."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(HOST_PREFIX + name):
        yield


def profiler():
    """A ``torch.profiler.profile`` over the CPU and the card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def collect(prof) -> Trace:
    """The profiler's events as ``Trace``: device operations (``is_work``)
    and the benchmark's host spans, in the profiler's nanoseconds."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        op = Op(name, e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            if name.startswith(HOST_PREFIX):
                host.append(op)
        elif is_work(name):
            device.append(op)
    device.sort(key=lambda o: o.start_ns)
    host.sort(key=lambda o: o.start_ns)
    return Trace(device, host)


def is_work(name: str) -> bool:
    """Whether a row on the device's timeline is work: not one of the
    ``bench.*`` host spans that the profiler also draws there."""
    return not name.startswith(HOST_PREFIX)


def classify(name: str, patterns: Dict[str, Sequence[re.Pattern]]) -> str:
    """The layer whose patterns match ``name``, else ``OTHER``."""
    hits = [layer for layer, pats in patterns.items()
            if any(p.search(name) for p in pats)]
    if len(hits) > 1:
        raise ValueError(f"device operation {name!r} matches the patterns "
                         f"of several layers: {hits}")
    return hits[0] if hits else OTHER


def layer_of(ops: Iterable[Op], patterns) -> Dict[str, str]:
    """{operation name: its layer} for every distinct name in ``ops``."""
    return {name: classify(name, patterns) for name in {o.name for o in ops}}


def seconds_by_layer(ops: Iterable[Op], layers: Dict[str, str]) -> Dict[str, float]:
    """Summed device seconds of the operations of each layer; ``layers``
    as ``layer_of`` gives it."""
    out: Dict[str, float] = defaultdict(float)
    for op in ops:
        out[layers[op.name]] += (op.end_ns - op.start_ns) / 1e9
    return dict(out)


def merged(ops: Iterable[Op]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, as disjoint sorted
    (start, end) pairs."""
    out: List[List[int]] = []
    for lo, hi in sorted((o.start_ns, o.end_ns) for o in ops):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def busy_seconds(ops: Iterable[Op]) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(hi - lo for lo, hi in merged(ops)) / 1e9


def idle_share(busy_s: float, window_s: float) -> float:
    """1 - busy / window: the share of the window with nothing running."""
    if window_s <= 0:
        raise ValueError(f"window {window_s} s")
    return 1.0 - busy_s / window_s


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, at most 160 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i in range(len(name) - 1, -1, -1):       # the trailing (...) list
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    if name.endswith(")") and cut > 0:
        name = name[:cut]
    return name[:160]


def device_ops(ops: Iterable[Op]) -> List[list]:
    """[[name, seconds]] of the device operations that took most time,
    summed by ``short_name``, at most ``TOP``."""
    total: Dict[str, float] = defaultdict(float)
    for op in ops:
        total[short_name(op.name)] += (op.end_ns - op.start_ns) / 1e9
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]


def innermost(host: Sequence[Op]) -> List[Op]:
    """The host's timeline as disjoint (label, start, end) pieces, each
    labelled by the innermost ``bench.*`` span open over it (the spans
    nest: the window holds each call's spans)."""
    bounds = sorted({t for h in host for t in (h.start_ns, h.end_ns)})
    spans = sorted(host, key=lambda h: (h.start_ns, -h.end_ns))
    out, stack, i = [], [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i].start_ns <= lo:
            stack.append(spans[i])
            i += 1
        stack = [h for h in stack if h.end_ns > lo]
        if stack:
            out.append(Op(stack[-1].name, lo, hi))
    return out


def idle_gaps(ops: Sequence[Op], host: Sequence[Op]) -> List[list]:
    """[[what the host was doing, seconds]]: the time between device
    activity, split by the innermost ``bench.*`` host span open over each
    part of it (``host.none`` where none is), summed by name, the longest
    first, at most ``TOP``."""
    busy = merged(ops)
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    pieces = innermost(host)
    total: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(pieces) and pieces[j].end_ns <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k].start_ns < g1:
            part = min(g1, pieces[k].end_ns) - max(g0, pieces[k].start_ns)
            if part > 0:
                total[pieces[k].name] += part / 1e9
                covered += part
            k += 1
        if g1 - g0 > covered:
            total["host.none"] += (g1 - g0 - covered) / 1e9
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]
