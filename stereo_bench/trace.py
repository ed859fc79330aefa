"""The traced window: ``torch.profiler`` over the measured loop, reduced
to device operations by layer, the device's busy time and the idle gaps
by what the host was doing.

The benchmark marks its own host phases with ``record_function`` spans
named ``bench.<phase>``; the program marks its own layers with host spans
named ``sgm.<layer>``, which draw no row on the device's timeline.  Both
kinds are kept, so an idle gap is named by the innermost span of either
kind, and a device operation can be put in the program's span that was
open when the host function that launched it started (the profiler's
correlation id).  A device operation belongs to the layer whose patterns
(``layers/<layer>/*.txt``) its name matches, or to ``other``; a name that
two layers claim is an error, so that a pattern file added later cannot
count a kernel twice.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

OTHER = "other"
HOST_PREFIX = "bench."
PROGRAM_PREFIX = "sgm."     # the program's spans, by name: nothing imported
HOST_NONE = "host.none"     # no span open on the host
TOP = 10


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: List[Op]    # kernels, copies and sets the device ran
    host: List[Op]      # the benchmark's bench.* and the program's sgm.* spans
    launched: List[int]  # for each device operation, the start of the host
                         # function open around its launch (0: not known)


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
    with the start of the host function that launched each, and the host
    spans of the benchmark and of the program, in the profiler's
    nanoseconds.  A device operation's linked correlation id is that of
    the host function open around its launch (a PyTorch operator, or a
    program span itself); the CUDA runtime's own host calls, which are
    linked to that function, are not recorded functions."""
    from torch.autograd import DeviceType

    device, host, started = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        op = Op(name, e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            if e.linked_correlation_id() == 0:
                started[e.correlation_id()] = op.start_ns
            if name.startswith((HOST_PREFIX, PROGRAM_PREFIX)):
                host.append(op)
        elif is_work(name):
            device.append((op, e.linked_correlation_id()))
    device.sort(key=lambda d: d[0].start_ns)
    host.sort(key=lambda o: o.start_ns)
    return Trace([op for op, _ in device], host,
                 [started.get(link, 0) if link else 0 for _, link in device])


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
    labelled by the innermost span open over it (the spans nest: the
    window holds each call's ``bench.*`` spans, ``bench.match_batch`` the
    program's ``sgm.match`` and that its stages)."""
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


def idle_by_span(ops: Sequence[Op], host: Sequence[Op]) -> Dict[str, float]:
    """{what the host was doing: seconds}: the time between device
    activity, split by the innermost host span open over each part of it
    (``HOST_NONE`` where none is), summed by name."""
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
            total[HOST_NONE] += (g1 - g0 - covered) / 1e9
    return dict(total)


def idle_gaps(ops: Sequence[Op], host: Sequence[Op]) -> List[list]:
    """[[what the host was doing, seconds]] of ``idle_by_span``, the
    longest first, at most ``TOP``."""
    total = idle_by_span(ops, host)
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]


def seconds_by_span(tr: Trace) -> Dict[str, Dict[str, float]]:
    """{program span: {operation name: device seconds}}: each device
    operation under the innermost program span (``sgm.*``) open when the
    host function that launched it started, ``HOST_NONE`` where none was
    or the launch is not known."""
    pieces = innermost([h for h in tr.host if h.name.startswith(PROGRAM_PREFIX)])
    starts = [p.start_ns for p in pieces]
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for op, t in zip(tr.device, tr.launched):
        i = bisect.bisect_right(starts, t) - 1
        inside = t > 0 and i >= 0 and t < pieces[i].end_ns
        span = pieces[i].name if inside else HOST_NONE
        out[span][op.name] += (op.end_ns - op.start_ns) / 1e9
    return {span: dict(by_op) for span, by_op in out.items()}


def span_seconds(host: Iterable[Op]) -> Dict[str, float]:
    """Summed host seconds of the program's spans, by name."""
    out: Dict[str, float] = defaultdict(float)
    for h in host:
        if h.name.startswith(PROGRAM_PREFIX):
            out[h.name] += (h.end_ns - h.start_ns) / 1e9
    return dict(out)
