"""The trace reader against the program's own spans.

Under a recording ``torch.profiler`` the port marks its layers with host
spans named ``sgm.<layer>`` (``utils.profiling.span`` in the port): a host
event each, drawn on no device timeline.  ``trace_kitti2015_stream_spans.json``
holds two ``kitti2015.stream`` frames traced on the card with both the
benchmark's ``bench.*`` spans and the program's ``sgm.*`` spans, in the
format of ``trace_kitti2015_stream.json``.  These tests hold that:

* the program draws no row on the device's timeline, so ``collect`` gives
  the same trace whether the program's spans are there or not, and every
  reading taken from it (the layers' seconds, ``busy_seconds``,
  ``idle_share``, ``device_ops``, the per-layer readers) is unchanged, on
  the committed trace of the parent program with spans inserted and on the
  trace of this program;
* given the program's spans beside the benchmark's, ``idle_gaps`` splits
  the time it put down to ``bench.match_batch`` over the ``sgm.*`` spans
  and loses none of it (``collect`` keeps ``bench.*`` host spans only: the
  program's spans reach the breakdown once it keeps ``sgm.*`` too).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from stereo_bench import spec, trace

DATA = Path(__file__).parent / "data"
PARENT = json.loads((DATA / "trace_kitti2015_stream.json").read_text())
SPANS = json.loads((DATA / "trace_kitti2015_stream_spans.json").read_text())
PROGRAM = "sgm."
STAGES = ["sgm.upload", "sgm.census", "sgm.aggregate", "sgm.finalize",
          "sgm.lr_check", "sgm.speckle", "sgm.median"]


def ops(rows):
    return [trace.Op(n, a, b) for n, a, b in rows]


def inserted(saved):
    """``saved`` with the program's spans inserted: in each
    ``bench.match_batch`` an ``sgm.match`` 1 us inside it, cut into the
    seven stages in equal parts, and an ``sgm.plan`` in the aggregation."""
    host = list(saved["host"])
    for name, a, b in saved["host"]:
        if name != "bench.match_batch":
            continue
        a, b = a + 1000, b - 1000
        host.append(["sgm.match", a, b])
        step = (b - a) // len(STAGES)
        for k, stage in enumerate(STAGES):
            lo, hi = a + k * step, a + (k + 1) * step
            host.append([stage, lo, hi])
            if stage == "sgm.aggregate":
                host.append(["sgm.plan", lo + step // 4, lo + step // 2])
    return dict(saved, host=sorted(host, key=lambda r: r[1]))


class Event:
    """A profiler event as ``trace.collect`` reads it."""

    def __init__(self, row, device_type):
        self.row, self.type = row, device_type

    def name(self):
        return self.row[0]

    def start_ns(self):
        return self.row[1]

    def duration_ns(self):
        return self.row[2] - self.row[1]

    def device_type(self):
        return self.type


def profiler_of(saved):
    """A finished profiler whose events are the saved rows: the device rows
    on the card, the host spans on the CPU."""
    from torch.autograd import DeviceType

    events = [Event(r, DeviceType.CUDA) for r in saved["device"]] + \
        [Event(r, DeviceType.CPU) for r in saved["host"]]
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def without_program(saved):
    return dict(saved, host=[r for r in saved["host"]
                             if not r[0].startswith(PROGRAM)])


def readings(tr, window_s, frames=2):
    """Everything the benchmark reads from a traced window's trace."""
    layers = trace.layer_of(tr.device, spec.layer_patterns())
    traced = SimpleNamespace(frames=frames, window_s=window_s,
                             busy_s=trace.busy_seconds(tr.device),
                             layer_s=trace.seconds_by_layer(tr.device, layers))
    record = SimpleNamespace(traced=traced, traffic={"feed": "host"},
                             height=375, width=1242, disparities=192, paths=8)
    metrics = {m["name"]: spec.reader(m["name"])(record)
               for m in spec.metrics_of(spec.load_benchmark(),
                                        "kitti2015.stream", True)
               if m["name"] != "host_call_ms.stream"}
    return {"busy": traced.busy_s, "layers": traced.layer_s,
            "idle_share": trace.idle_share(traced.busy_s, window_s),
            "device_ops": trace.device_ops(tr.device),
            "idle_gaps": trace.idle_gaps(tr.device, tr.host),
            "metrics": metrics}


def test_the_program_draws_nothing_on_the_device_timeline():
    assert not [r for r in SPANS["device"] if r[0].startswith(PROGRAM)]
    names = [r[0] for r in SPANS["host"]]
    assert names.count("sgm.match") == names.count("bench.match_batch") == 2
    for stage in STAGES:
        assert names.count(stage) == 2
    assert "sgm.plan" in names
    # the parent program's trace: only the benchmark's spans
    assert not [r for r in PARENT["host"] + PARENT["device"]
                if r[0].startswith(PROGRAM)]


@pytest.mark.parametrize("saved", [inserted(PARENT), SPANS],
                         ids=["parent_with_spans_inserted", "this_program"])
def test_every_reading_is_the_same_with_and_without_program_spans(saved):
    with_spans = trace.collect(profiler_of(saved))
    plain = trace.collect(profiler_of(without_program(saved)))
    assert with_spans == plain
    assert not [o for o in with_spans.host if o.name.startswith(PROGRAM)]
    window = max(r[2] for r in saved["host"]) / 1e9
    assert readings(with_spans, window) == readings(plain, window)
    if saved is not SPANS:
        original = trace.collect(profiler_of(PARENT))
        assert original == plain
        assert readings(original, window) == readings(plain, window)


@pytest.mark.parametrize("saved", [inserted(PARENT), SPANS],
                         ids=["parent_with_spans_inserted", "this_program"])
def test_idle_gaps_split_match_batch_over_the_program_spans(saved,
                                                             monkeypatch):
    monkeypatch.setattr(trace, "TOP", 100)      # every name, for the sums
    tr = trace.collect(profiler_of(saved))
    program = ops(r for r in saved["host"] if r[0].startswith(PROGRAM))
    bench = dict(trace.idle_gaps(tr.device, tr.host))
    both = dict(trace.idle_gaps(tr.device, sorted(
        tr.host + program, key=lambda o: o.start_ns)))
    assert sum(both.values()) == pytest.approx(sum(bench.values()))
    for name in ("bench.window", "bench.download", "host.none"):
        assert both.get(name, 0) == pytest.approx(bench.get(name, 0))
    moved = sum(s for n, s in both.items() if n.startswith(PROGRAM))
    assert moved > 0
    assert moved + both.get("bench.match_batch", 0) == \
        pytest.approx(bench["bench.match_batch"])
    if saved is SPANS:
        # on the card, the program's stages hold most of that time
        children = moved - both.get("sgm.match", 0)
        assert children >= 0.9 * bench["bench.match_batch"]
