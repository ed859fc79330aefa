"""The trace reader against the program's own spans.

Under a recording ``torch.profiler`` the port marks its layers with host
spans named ``sgm.<layer>`` (``utils.profiling.span`` in the port): a host
event each, drawn on no device timeline.  ``trace_kitti2015_stream_spans.json``
holds two ``kitti2015.stream`` frames traced on the card with both the
benchmark's ``bench.*`` spans and the program's ``sgm.*`` spans, in the
format of ``trace_kitti2015_stream.json``.  These tests hold that:

* the program draws no row on the device's timeline, so ``collect`` gives
  the same device rows whether the program's spans are there or not, and
  every reading taken from them (the layers' seconds, ``busy_seconds``,
  ``idle_share``, ``device_ops``, the per-layer readers of the device) is
  unchanged, on the committed trace of the parent program with spans
  inserted and on the trace of this program;
* ``collect`` keeps the program's ``sgm.*`` spans beside the benchmark's
  ``bench.*`` ones, and ``idle_gaps`` splits the time it put down to
  ``bench.match_batch`` without them over the ``sgm.*`` spans, losing none
  of it;
* a device operation is put in the program's span that was open when the
  host function that launched it started (``seconds_by_span``; the saved
  rows carry no launch links, so the upload's rate, which reads the copies
  launched under ``sgm.upload``, is read on events made by hand), and the
  window's counts and spans reach the readers (``run_cell`` on the CPU with
  the counters driven by hand).
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
    """A profiler event as ``trace.collect`` reads it: ``link`` the linked
    correlation id (a device operation's launching host function; 0 on a
    recorded host function), ``corr`` its own."""

    def __init__(self, row, device_type, corr=0, link=0):
        self.row, self.type, self.corr, self.link = row, device_type, corr, link

    def name(self):
        return self.row[0]

    def start_ns(self):
        return self.row[1]

    def duration_ns(self):
        return self.row[2] - self.row[1]

    def device_type(self):
        return self.type

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


def profiler_of(saved, extra=()):
    """A finished profiler whose events are the saved rows: the device rows
    on the card, the host spans on the CPU; and the ``extra`` events."""
    from torch.autograd import DeviceType

    events = [Event(r, DeviceType.CUDA) for r in saved["device"]] + \
        [Event(r, DeviceType.CPU, corr=k + 1)
         for k, r in enumerate(saved["host"])] + list(extra)
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def without_program(saved):
    return dict(saved, host=[r for r in saved["host"]
                             if not r[0].startswith(PROGRAM)])


# the readers of the program's spans: they read nothing without them
HOST_SPAN_READERS = ("idle_in_program_ms_per_frame.stream", "upload_gbps.stream")


def readings(tr, window_s, frames=2):
    """Everything the benchmark reads from a traced window's trace (two
    stream frames: 931,500 bytes uploaded each, 9 launches and 4 planning
    queries a call)."""
    layers = trace.layer_of(tr.device, spec.layer_patterns())
    traced = SimpleNamespace(frames=frames, calls=frames, window_s=window_s,
                             busy_s=trace.busy_seconds(tr.device),
                             layer_s=trace.seconds_by_layer(tr.device, layers),
                             idle_s=trace.idle_by_span(tr.device, tr.host),
                             span_s=trace.span_seconds(tr.host),
                             span_device_s=trace.seconds_by_span(tr),
                             launches=9 * frames, plan_queries=4 * frames,
                             upload_bytes=931_500 * frames)
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


def of_the_device(readings):
    """The readings taken from the device rows and the counts: all but the
    idle gaps and the metrics that the host's spans name."""
    out = {k: v for k, v in readings.items() if k != "idle_gaps"}
    out["metrics"] = {k: v for k, v in readings["metrics"].items()
                      if k not in HOST_SPAN_READERS}
    return out


@pytest.mark.parametrize("saved", [inserted(PARENT), SPANS],
                         ids=["parent_with_spans_inserted", "this_program"])
def test_every_reading_is_the_same_with_and_without_program_spans(saved):
    with_spans = trace.collect(profiler_of(saved))
    plain = trace.collect(profiler_of(without_program(saved)))
    assert with_spans.device == plain.device
    assert with_spans.launched == plain.launched
    program = [o for o in with_spans.host if o.name.startswith(PROGRAM)]
    assert program == ops(r for r in saved["host"] if r[0].startswith(PROGRAM))
    assert [o for o in with_spans.host if o not in program] == plain.host
    window = max(r[2] for r in saved["host"]) / 1e9
    assert of_the_device(readings(with_spans, window)) == \
        of_the_device(readings(plain, window))
    gaps = dict(readings(with_spans, window)["idle_gaps"])
    assert any(name.startswith(PROGRAM) for name in gaps)
    metrics = readings(with_spans, window)["metrics"]
    assert metrics["idle_in_program_ms_per_frame.stream"] > 0
    assert metrics["upload_gbps.stream"] is None     # no launch links saved
    assert all(readings(plain, window)["metrics"][k] is None
               for k in HOST_SPAN_READERS)
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
    plain = trace.collect(profiler_of(without_program(saved)))
    bench = dict(trace.idle_gaps(plain.device, plain.host))
    both = dict(trace.idle_gaps(tr.device, tr.host))
    assert both == pytest.approx(trace.idle_by_span(tr.device, tr.host))
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


def test_idle_in_program_reads_the_gaps_under_the_program_spans(monkeypatch):
    monkeypatch.setattr(trace, "TOP", 100)
    tr = trace.collect(profiler_of(SPANS))
    window = max(r[2] for r in SPANS["host"]) / 1e9
    gaps = dict(trace.idle_gaps(tr.device, tr.host))
    under = sum(s for n, s in gaps.items() if n.startswith(PROGRAM))
    metrics = readings(tr, window)["metrics"]
    assert metrics["idle_in_program_ms_per_frame.stream"] == \
        pytest.approx(under * 1e3 / 2)
    assert metrics["kernel_launches_per_call.stream"] == 9
    assert metrics["plan_queries_per_call.stream"] == 4


def test_a_device_operation_is_put_in_the_span_open_at_its_launch():
    """The upload's copy launched by a PyTorch operator that started in
    ``sgm.upload``, K1 launched by the program span itself (a C entry under
    ``sgm.census``), a glue kernel by an operator that started in
    ``sgm.finalize``, a copy whose launch is not known, and a kernel
    launched by an operator outside every program span; the upload's rate
    reads the copy under ``sgm.upload`` alone."""
    from torch.autograd import DeviceType

    host = [["bench.match_batch", 0, 1000], ["sgm.match", 10, 900],
            ["sgm.upload", 11, 19], ["aten::copy_", 12, 15],
            ["sgm.census", 20, 100], ["sgm.finalize", 300, 400],
            ["aten::div", 320, 330], ["aten::add", 950, 960]]
    htod, dtoh = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pinned)"
    glue = "at::native::vectorized_elementwise_kernel"
    device = [[htod, 150, 190, 4], ["census_cost_kernel", 200, 260, 5],
              [glue, 500, 510, 7], [dtoh, 600, 640, 0], [glue, 970, 975, 8]]
    events = [Event(r, DeviceType.CPU, corr=k + 1) for k, r in enumerate(host)]
    events += [Event(r[:3], DeviceType.CUDA, link=r[3]) for r in device]
    # the CUDA runtime's host call, linked to the operator that made it
    events.append(Event(["cudaLaunchKernel", 322, 324], DeviceType.CPU,
                        corr=99, link=7))
    tr = trace.collect(profiler_of({"device": [], "host": []}, events))
    assert [o.name for o in tr.host] == [r[0] for r in host
                                         if r[0].startswith(("bench.", PROGRAM))]
    assert tr.launched == [12, 20, 320, 0, 950]
    by_span = trace.seconds_by_span(tr)
    assert by_span == {"sgm.upload": {htod: 40e-9},
                       "sgm.census": {"census_cost_kernel": 60e-9},
                       "sgm.finalize": {glue: 10e-9},
                       "host.none": {dtoh: 40e-9, glue: 5e-9}}
    assert trace.span_seconds(tr.host) == pytest.approx(
        {"sgm.match": 890e-9, "sgm.upload": 8e-9, "sgm.census": 80e-9,
         "sgm.finalize": 100e-9})
    traced = SimpleNamespace(span_device_s=by_span, upload_bytes=80)
    record = SimpleNamespace(traced=traced, traffic={"feed": "host"})
    assert spec.reader("upload_gbps.stream")(record) == pytest.approx(2.0)


def test_run_cell_puts_the_program_counts_on_the_record(monkeypatch):
    """A traced ``run_cell`` on the CPU with the program's counters driven
    by hand each call: 3 launches of the main path's entries and one of a
    probe (not counted), 4 planning queries, 1,000 uploaded bytes."""
    from soc_project_stereo_matching_tpu_torch import SGMEngine
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from stereo_bench import harness

    sound = SGMEngine.match_batch

    def counted(self, left, right):
        kernels.LAUNCHES["census_cost_volume"] += 1
        kernels.LAUNCHES["volume_transpose"] += 2
        kernels.LAUNCHES["probe_chain"] += 1
        kernels.PLAN_QUERIES["sgm_scan_group_capacity"] += 4
        self.upload_bytes += 1000
        return sound(self, left, right)

    monkeypatch.setattr(SGMEngine, "match_batch", counted)
    records = []
    reader = spec.reader
    monkeypatch.setattr(spec, "reader", lambda name: lambda r: (
        records.append(r), reader(name)(r))[1])
    bench = spec.load_benchmark()
    config = spec.config(bench, "kitti2015")
    config = dict(config, height=24, width=64,
                  options=dict(config["options"], max_disparity=16,
                               min_speckle_area=6))
    result = harness.run_cell(bench, "kitti2015.stream", 2 ** 33 + 9, 0.3,
                              True, device="cpu", config=config)
    assert result["correct"]
    t = records[0].traced
    assert t.calls >= 1 and t.frames == t.calls
    assert (t.launches, t.plan_queries, t.upload_bytes) == \
        (3 * t.calls, 4 * t.calls, 1000 * t.calls)
    assert set(STAGES) <= set(t.span_s) and "sgm.match" in t.span_s
    # no device operations on the CPU: the upload's rate, which reads the
    # device's copies, finds nothing and is left out of the line
    assert t.span_device_s == {}
    metrics = result["metrics"]
    assert metrics["kernel_launches_per_call.stream"]["value"] == 3
    assert metrics["plan_queries_per_call.stream"]["value"] == 4
    assert "upload_gbps.stream" not in metrics
    assert metrics["idle_in_program_ms_per_frame.stream"]["unit"] == "ms"
