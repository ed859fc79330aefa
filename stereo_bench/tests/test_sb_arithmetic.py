"""The arithmetic of the metrics: the rate over the window, the 95th
percentile over every frame, the union of device intervals and the idle
share, the kernel-name classification on a small trace saved from the
card, K2's bytes and operations, and which window each reader reads."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from stereo_bench import roofline, spec, stats, trace

SAVED = json.loads((Path(__file__).parent / "data"
                    / "trace_kitti2015_stream.json").read_text())


def ops(rows):
    return [trace.Op(n, a, b) for n, a, b in rows]


def test_rate_is_frames_over_the_whole_window():
    assert stats.rate(620, 10.0) == 62.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_frame():
    xs = [10.0] * 95 + [20.0] * 5          # the tail: 5 frames of 100
    assert stats.percentile(xs, 95) == pytest.approx(10.0 + 0.05 * 10.0)
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 95) == float(np.percentile(xs, 95))


def test_busy_is_the_union_of_overlapping_intervals():
    rows = ops([["a", 0, 10], ["b", 5, 15], ["c", 20, 30], ["d", 22, 25]])
    assert trace.merged(rows) == [(0, 15), (20, 30)]
    assert trace.busy_seconds(rows) == pytest.approx(25e-9)
    assert trace.idle_share(25e-9, 40e-9) == pytest.approx(1 - 25 / 40)
    with pytest.raises(ValueError):
        trace.idle_share(1.0, 0.0)


def test_saved_trace_classifies_every_operation():
    device = [o for o in ops(SAVED["device"]) if trace.is_work(o.name)]
    assert len(device) < len(SAVED["device"])      # the bench.* rows go
    patterns = spec.layer_patterns()
    names = trace.layer_of(device, patterns)
    layers = trace.seconds_by_layer(device, names)
    assert trace.OTHER not in layers
    assert set(layers) == {"engine", "kernels_k2", "kernels_k134", "plain_glue"}
    k2 = layers["kernels_k2"]
    assert k2 > 0.85 * sum(layers.values())
    assert all(v == "kernels_k2" for n, v in names.items() if "group_kernel" in n)
    assert all(v == "plain_glue" for n, v in names.items() if "at::native" in n)
    assert {v for n, v in names.items() if n.startswith("Memcpy H")} == {"engine"}
    assert {v for n, v in names.items() if "census_cost" in n} == {"kernels_k134"}


def test_a_name_that_two_layers_claim_is_an_error():
    import re

    patterns = {"a": [re.compile("kernel")], "b": [re.compile("group")]}
    assert trace.classify("scan", patterns) == trace.OTHER
    with pytest.raises(ValueError):
        trace.classify("group_kernel", patterns)


def test_idle_gaps_are_named_by_the_host_span():
    device = [o for o in ops(SAVED["device"]) if trace.is_work(o.name)]
    gaps = trace.idle_gaps(device, ops(SAVED["host"]))
    assert gaps and len(gaps) <= trace.TOP
    assert {n for n, _ in gaps} <= {"bench.window", "bench.match_batch",
                                    "bench.download", "host.none"}
    busy = trace.merged(device)
    idle = sum(b[0] - a[1] for a, b in zip(busy, busy[1:])) / 1e9
    assert sum(s for _, s in gaps) == pytest.approx(idle)
    tops = trace.device_ops(device)
    assert tops[0][0].startswith("group_kernel<")
    assert [s for _, s in tops] == sorted((s for _, s in tops), reverse=True)


def test_short_name():
    name = ("void (anonymous namespace)::group_kernel<1, true, false>"
            "((anonymous namespace)::GroupArgs)")
    assert trace.short_name(name) == "group_kernel<1, true, false>"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD "


def test_k2_counts_by_hand():
    # H=2, W=3, D=4: 24 cost bytes, 6 image bytes, 2 views x 5 planes x
    # 4 bytes x 6 pixels = 240 plane bytes; 10 ops x 8 paths x 24 elements
    assert roofline.k2_bytes(2, 3, 4) == 24 + 6 + 240
    assert roofline.k2_ops(2, 3, 4) == 1920
    # a KITTI frame: the operations bound it
    h, w, d = 375, 1242, 192
    assert roofline.k2_least_seconds(h, w, d) == pytest.approx(
        10 * 8 * h * w * d / 67e12)
    assert roofline.k2_bytes(h, w, d) / 3.35e12 < roofline.k2_ops(h, w, d) / 67e12


def record(**kw):
    base = dict(frames=100, elapsed_s=2.0, frame_ms=[], host_call_s=[],
                peak_bytes=2 ** 30, setup_s=7.5, height=375, width=1242,
                disparities=192, paths=8, traced=None,
                traffic={"feed": "resident"})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    # the untraced window: 100 frames; the traced one: 50 frames
    traced = SimpleNamespace(frames=50, window_s=2.0, busy_s=1.5,
                             layer_s={"kernels_k2": 0.25, "kernels_k134": 0.005,
                                      "plain_glue": 0.01, "engine": 0.0015})
    r = record(traced=traced, frame_ms=[10.0] * 99 + [30.0],
               host_call_s=[0.002] * 100, traffic={"feed": "host"})
    read = lambda name, rec=r: spec.reader(name)(rec)
    assert read("fps") == 50.0
    assert read("peak_mem_gib") == 1.0
    assert read("setup_s") == 7.5
    assert read("frame_ms_p95") == pytest.approx(10.0)
    assert read("k2_ms_per_frame") == pytest.approx(5.0)
    assert read("k134_ms_per_frame") == pytest.approx(0.1)
    assert read("glue_ms_per_frame") == pytest.approx(0.2)
    assert read("copy_ms.stream") == pytest.approx(0.03)
    assert read("host_call_ms.stream") == pytest.approx(2.0)
    assert read("idle_share") == pytest.approx(0.25)
    least = roofline.k2_least_seconds(375, 1242, 192)
    assert read("k2_roofline") == pytest.approx(100 * least / 5e-3)


def test_the_program_readers():
    # the traced window: 40 calls of 2 frames; idle under the program's
    # spans 0.004 s, under the benchmark's 0.010 s; 40 MB uploaded by
    # host-to-device copies of 0.02 s on the device, launched under the
    # sgm.upload spans (a kernel there and the download's copy outside
    # them are not the upload's copies)
    traced = SimpleNamespace(
        frames=80, calls=40, window_s=2.0, busy_s=1.9, layer_s={},
        idle_s={"sgm.upload": 0.003, "sgm.plan": 0.001,
                "bench.download": 0.010, "host.none": 0.002},
        span_s={"sgm.match": 0.5, "sgm.upload": 0.3},
        span_device_s={
            "sgm.upload": {"Memcpy HtoD (Pageable -> Device)": 0.02,
                           "at::native::elementwise_kernel": 0.5},
            "host.none": {"Memcpy DtoH (Device -> Pageable)": 0.03}},
        launches=360, plan_queries=160, upload_bytes=40_000_000)
    r = record(traced=traced, traffic={"feed": "host"})
    read = lambda name, rec=r: spec.reader(name)(rec)
    assert read("idle_in_program_ms_per_frame") == pytest.approx(0.05)
    assert read("upload_gbps.stream") == pytest.approx(2.0)
    assert read("kernel_launches_per_call") == 9
    assert read("plan_queries_per_call") == 4
    resident = record(traced=traced)
    assert read("upload_gbps.stream", resident) is None
    assert read("kernel_launches_per_call", resident) == 9
    # a traced window in which the program marked nothing
    bare = record(traced=SimpleNamespace(**dict(
        vars(traced), span_s={}, idle_s={"host.none": 0.1},
        span_device_s={"host.none": {"Memcpy HtoD (Pageable -> Device)": 0.02}})))
    assert read("idle_in_program_ms_per_frame", bare) is None
    assert read("upload_gbps.stream", bare) is None


def test_a_metric_split_by_cells_is_read_by_its_quantity():
    """``<quantity>.<cells>`` without a reader of its own (the stream's
    ``fps.stream``, ``k2_ms_per_frame.stream``) reads what ``<quantity>``
    reads; one with its own (``upload_gbps.stream``) keeps it; a name whose
    quantity has no reader is refused."""
    traced = SimpleNamespace(
        frames=50, calls=50, window_s=2.0, busy_s=1.5,
        layer_s={"kernels_k2": 0.25, "kernels_k134": 0.005,
                 "plain_glue": 0.01, "engine": 0.0015},
        idle_s={"sgm.upload": 0.003}, span_s={"sgm.upload": 0.01},
        span_device_s={}, launches=450, plan_queries=200, upload_bytes=1)
    r = record(traced=traced, traffic={"feed": "host"})
    bench = spec.load_benchmark()
    split = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
             if "." in m["name"]
             and not (spec.METRICS_DIR / f"{m['name']}.py").is_file()]
    assert {"fps.stream", "k2_ms_per_frame.stream", "k2_roofline.stream",
            "kernel_launches_per_call.stream"} <= set(split)
    for name in split:
        quantity = name.split(".")[0]
        assert spec.reader(name)(r) == spec.reader(quantity)(r), name
        assert spec.reader(name)(r) is not None, name
    assert spec.reader("upload_gbps.stream")(r) is None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_quantity.stream")


def test_the_host_clock_reader_reads_the_untraced_window():
    """The traced window's calls are slower on the host (the profiler's
    own cost); ``host_call_ms.stream`` reads the untraced one's."""
    traced = SimpleNamespace(frames=10, window_s=1.0, busy_s=0.5, layer_s={})
    r = record(traced=traced, host_call_s=[0.001] * 100,
               traffic={"feed": "host"})
    assert spec.reader("host_call_ms.stream")(r) == pytest.approx(1.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = record()
    for name in ("frame_ms_p95", "k2_ms_per_frame", "k2_roofline",
                 "k134_ms_per_frame", "glue_ms_per_frame", "copy_ms.stream",
                 "host_call_ms.stream", "idle_share",
                 "idle_in_program_ms_per_frame", "upload_gbps.stream",
                 "plan_queries_per_call", "kernel_launches_per_call",
                 "k2_ms_per_frame.stream", "idle_share.stream",
                 "plan_queries_per_call.stream"):
        assert spec.reader(name)(r) is None, name


def test_an_idle_gap_is_split_over_the_host_spans_it_overlaps():
    host = ops([["bench.window", 0, 100], ["bench.a", 10, 40],
                ["bench.b", 40, 70]])
    device = ops([["k", 0, 5], ["k", 30, 50], ["k", 90, 95]])
    assert trace.innermost(host) == ops([["bench.window", 0, 10],
                                         ["bench.a", 10, 40],
                                         ["bench.b", 40, 70],
                                         ["bench.window", 70, 100]])
    gaps = dict(trace.idle_gaps(device, host))
    assert gaps == pytest.approx({"bench.window": 25e-9, "bench.a": 20e-9,
                                  "bench.b": 20e-9})
    assert dict(trace.idle_gaps(device, [])) == pytest.approx(
        {"host.none": 65e-9})
