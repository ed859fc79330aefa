"""The port's spans and counters: ``utils.profiling.span`` in
``SGMEngine.match`` and ``sgm_forward``, ``sgm.plan`` and
``kernels.PLAN_QUERIES`` around the asking C entries,
``SGMEngine.upload_bytes``, and the arithmetic by which
``stage_breakdown`` reads them from a profiler window.

The tests without a card run the plain path (``device="cpu"``) under
``torch.profiler`` on the CPU; those marked ``cuda`` need a card and skip
without one.  The file imports no JAX and nothing of the JAX package:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import ctypes

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soc_project_stereo_matching_tpu_torch import (SGMEngine, SGMOptions,
                                                   _build, stage_breakdown)
from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair
from soc_project_stereo_matching_tpu_torch.ops import kernels
from soc_project_stereo_matching_tpu_torch.stage_breakdown import (Event,
                                                                   Profile)
from soc_project_stereo_matching_tpu_torch.utils import profiling

H, W, DMAX = 24, 40, 16
KITTI = dict(h=375, w=1242, dmax=192)
ALL_STAGES = ["sgm.upload", "sgm.census", "sgm.aggregate", "sgm.finalize",
              "sgm.lr_check", "sgm.speckle", "sgm.median"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def pair(batch=1, h=H, w=W, dmax=DMAX):
    left, right, _ = synthetic_pair(5, batch, h, w,
                                    tuple(dmax * f // 64 for f in (10, 20, 35)))
    return left, right


def cpu_profile(fn):
    """The ``stage_breakdown.Profile`` of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return stage_breakdown.collect(prof)


def children(spans, parent):
    """The spans whose innermost enclosing span is ``parent``, in order."""
    out = []
    for s in spans:
        around = [p for p in spans if p is not s and p.start_ns <= s.start_ns
                  and s.end_ns <= p.end_ns]
        if around and min(around, key=lambda p: p.end_ns - p.start_ns) is parent:
            out.append(s)
    return out


@pytest.mark.parametrize("lr,speckle,stages", [
    (True, True, ALL_STAGES),
    (False, False, ["sgm.upload", "sgm.census", "sgm.aggregate",
                    "sgm.finalize", "sgm.median"]),
])
def test_match_records_its_stage_spans_inside_sgm_match(lr, speckle, stages):
    engine = SGMEngine(SGMOptions(max_disparity=DMAX, is_check_lr=lr,
                                  is_remove_speckles=speckle), device="cpu")
    left, right = pair()
    want = engine.match(left, right)
    got = []
    prof = cpu_profile(lambda: got.append(engine.match(left, right)))
    assert torch.equal(got[0], want)            # the spans change nothing
    spans = prof.spans
    matches = [s for s in spans if s.name == "sgm.match"]
    assert len(matches) == 1
    inner = children(spans, matches[0])
    assert [s.name for s in inner] == stages
    for a, b in zip(inner, inner[1:]):
        assert a.end_ns <= b.start_ns
    # the plain path asks no C entry, and every span lies in sgm.match
    assert {s.name for s in spans} == {"sgm.match", *stages}
    m = matches[0]
    assert all(m.start_ns <= s.start_ns and s.end_ns <= m.end_ns
               for s in spans)


def test_match_batch_records_one_sgm_match_per_call():
    engine = SGMEngine(SGMOptions(max_disparity=DMAX), device="cpu")
    left, right = pair(batch=2)
    prof = cpu_profile(lambda: [engine.match_batch(left, right)
                                for _ in range(3)])
    names = [s.name for s in prof.spans]
    assert names.count("sgm.match") == 3
    assert names.count("sgm.census") == 3 and names.count("sgm.median") == 3


class Counting:
    """A context-manager class that counts its entries and does nothing."""

    entered = 0

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_match_enters_no_record_function_without_a_profiler(monkeypatch):
    class Fast(Counting):
        entered = 0

    class User(Counting):
        entered = 0

    monkeypatch.setattr(profiling, "_record", Fast)
    monkeypatch.setattr(torch.profiler, "record_function", User)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", User)
    engine = SGMEngine(SGMOptions(max_disparity=DMAX), device="cpu")
    left, right = pair()
    assert not torch.autograd._profiler_enabled()
    engine.match(left, right)
    engine.match_batch(left, right)
    assert Fast.entered == 0 and User.entered == 0
    # the same calls under a profiler go through the patched span
    with profile(activities=[ProfilerActivity.CPU]):
        engine.match(left, right)
    assert Fast.entered == len(ALL_STAGES) + 1 and User.entered == 0


def test_upload_bytes_add_nothing_on_a_cpu_engine():
    engine = SGMEngine(SGMOptions(max_disparity=DMAX), device="cpu")
    left, right = pair(batch=2)
    engine.match_batch(left, right)                       # numpy
    engine.match_batch(torch.from_numpy(left), torch.from_numpy(right))
    engine.match(left[0], right[0])
    assert engine.upload_bytes == 0


class FakeLib:
    """The capacity C entry: writes ``dirs`` and returns ``err``."""

    def __init__(self, dirs, err=0):
        self.dirs, self.err = dirs, err

    def sgm_scan_group_capacity(self, cost, out, b, d, w, wta, ranges, addr):
        ctypes.c_int.from_address(addr).value = self.dirs
        return self.err


def test_each_capacity_query_is_counted_and_spanned(monkeypatch):
    cost = torch.zeros((1, 4, DMAX, W), dtype=torch.uint8)
    out = torch.zeros(cost.shape, dtype=torch.uint16)
    monkeypatch.setattr(_build, "load", lambda: FakeLib(3))
    before = dict(kernels.PLAN_QUERIES)
    assert kernels.group_directions(cost, out) == 3
    prof = cpu_profile(lambda: kernels.group_directions(cost, out, True))
    assert [s.name for s in prof.spans] == ["sgm.plan"]
    assert kernels.PLAN_QUERIES["sgm_scan_group_capacity"] == \
        before["sgm_scan_group_capacity"] + 2
    monkeypatch.setattr(_build, "load", lambda: FakeLib(0, err=700))
    with pytest.raises(RuntimeError, match="sgm_scan_group_capacity: CUDA "
                                           "error 700"):
        kernels.group_directions(cost, out)
    after = dict(kernels.PLAN_QUERIES)
    assert after["sgm_scan_group_capacity"] == \
        before["sgm_scan_group_capacity"] + 3
    assert {k: after[k] - before[k] for k in after
            if k != "sgm_scan_group_capacity"} == \
        {"sgm_scan_group_plan": 0, "sgm_census_cost_plan": 0,
         "sgm_path_scan_plan": 0}


# --- stage_breakdown's reading of a window, on hand-made events -------------

def ev(name, a, b, corr=0):
    return Event(name, a, b, corr)


def test_enclosing_finds_the_innermost_open_span():
    spans = [ev("sgm.match", 0, 100), ev("sgm.census", 10, 20),
             ev("sgm.plan", 12, 14), ev("sgm.aggregate", 30, 60),
             ev("sgm.match", 200, 300)]
    times = [5, 13, 15, 20, 45, 60, 150, 250, 300, -1]
    assert stage_breakdown.enclosing(times, spans) == \
        [0, 2, 1, 0, 3, 0, -1, 4, -1, -1]


def two_calls():
    """Two calls: upload (a copy, launched inside a PyTorch operator),
    census (one kernel, launched after a planning query), aggregate (two
    kernels); a call's host functions inside its spans, the operations later
    on the device, each with the id of the host function open around its
    launch."""
    host, device = [], []
    for k, t in enumerate((0, 1000)):
        c = 10 * k
        host += [ev("sgm.match", t, t + 500, c + 1),
                 ev("sgm.upload", t + 10, t + 50, c + 2),
                 ev("aten::copy_", t + 20, t + 30, c + 3),
                 ev("sgm.census", t + 60, t + 100, c + 4),
                 ev("sgm.plan", t + 62, t + 80, c + 5),
                 ev("sgm.aggregate", t + 110, t + 200, c + 6)]
        device += [ev("Memcpy HtoD", t + 100, t + 110, c + 3),
                   ev("census_cost_kernel", t + 300, t + 320, c + 4),
                   ev("group_kernel", t + 330, t + 400, c + 6),
                   ev("group_kernel", t + 400, t + 480, c + 6)]
    return Profile(device, host,
                   [e for e in host if e.name.startswith("sgm.")])


def test_device_ranges_follow_each_operation_to_its_launching_span():
    p = two_calls()
    ranges = stage_breakdown.device_ranges(p, stage_breakdown.STAGES)
    assert ranges == {"sgm.upload": [1e-5, 1e-5], "sgm.census": [2e-5, 2e-5],
                      "sgm.aggregate": [1.5e-4, 1.5e-4]}
    assert stage_breakdown.device_ranges(p, ("sgm.match",)) == \
        {"sgm.match": [3.8e-4, 3.8e-4]}
    # an operation launched outside any recorded function belongs nowhere
    lost = Profile(p.device + [ev("census_cost_kernel", 2000, 2100, 0)],
                   p.host, p.spans)
    assert stage_breakdown.device_ranges(lost, ("sgm.match",)) == \
        {"sgm.match": [3.8e-4, 3.8e-4]}


def test_idle_time_is_split_by_the_innermost_span_and_none_is_lost():
    p = two_calls()
    gaps = stage_breakdown.idle_by_span(p)
    busy = stage_breakdown.merged(p.device)
    idle = sum(b[0] - a[1] for a, b in zip(busy, busy[1:])) / 1e6
    assert sum(gaps.values()) == pytest.approx(idle)
    # call 1's device work ends at 480, call 2's starts at 1100: the host
    # was in call 1's sgm.match to 500, outside any span to 1000, in call
    # 2's sgm.match to 1010 and in its sgm.upload to 1050, ...
    assert gaps == pytest.approx({
        "sgm.aggregate": 2 * 90 / 1e6, "sgm.match": 260 / 1e6,
        "outside": 500 / 1e6, "sgm.upload": 40 / 1e6, "sgm.census": 22 / 1e6,
        "sgm.plan": 18 / 1e6})
    assert stage_breakdown.busy_ms(p) == pytest.approx(2 * 180 / 1e6)


class FakeKineto:
    def __init__(self, name, device, a, b, corr, linked, annotation=False):
        self._v = (name, device, a, b, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_collect_keeps_work_and_functions_not_annotations_or_runtime():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    rows = [("sgm.match", cpu, 0, 100, 1, 0),
            ("aten::empty", cpu, 5, 6, 2, 0),
            ("bench.match_batch", cpu, 0, 110, 3, 0, True),
            ("cudaLaunchKernel", cpu, 10, 12, 2, 1),
            ("cudaMemcpyAsync", cpu, 20, 22, 4, 2),
            ("group_kernel", cuda, 50, 90, 2, 1),
            ("census_cost_kernel", cuda, 30, 45, 3, 1),
            ("Memcpy HtoD", cuda, 25, 28, 4, 2),
            ("Memset", cuda, 29, 30, 5, 2),
            ("bench.match_batch", cuda, 25, 90, 3, 0, True)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {})()
    prof.profiler.kineto_results.events = \
        lambda: [FakeKineto(*r) for r in rows]
    p = stage_breakdown.collect(prof)
    assert [e.name for e in p.device] == ["Memcpy HtoD", "Memset",
                                          "census_cost_kernel", "group_kernel"]
    assert [e.correlation for e in p.device] == [2, 2, 1, 1]
    assert [e.name for e in p.host] == ["sgm.match", "bench.match_batch",
                                        "aten::empty"]
    assert p.spans == [Event("sgm.match", 0, 100, 1)]
    # the annotation row's 65 ns would have filled the gaps
    assert stage_breakdown.busy_ms(p) == pytest.approx((3 + 16 + 40) / 1e6)


# --- on the card ----------------------------------------------------------


@pytest.mark.cuda
def test_plan_queries_and_upload_bytes_per_kitti_frame(cuda):
    """A host-fed KITTI frame (375x1242 D=192): the same capacity queries
    every call, no plan asked twice, 2 H W bytes uploaded a frame."""
    engine = SGMEngine(SGMOptions(max_disparity=KITTI["dmax"]), device="cuda")
    left, right = pair(1, KITTI["h"], KITTI["w"], KITTI["dmax"])
    engine.match_batch(left, right)
    per_call = []
    for _ in range(3):
        before, up = dict(kernels.PLAN_QUERIES), engine.upload_bytes
        engine.match_batch(left, right).cpu()
        per_call.append({k: kernels.PLAN_QUERIES[k] - before[k]
                         for k in before})
        assert engine.upload_bytes - up == 2 * KITTI["h"] * KITTI["w"]
    assert per_call[0] == per_call[1] == per_call[2]
    assert per_call[0]["sgm_scan_group_capacity"] > 0
    assert per_call[0]["sgm_scan_group_plan"] == 0
    assert per_call[0]["sgm_census_cost_plan"] == 0
    resident = SGMEngine(SGMOptions(max_disparity=KITTI["dmax"]),
                         device="cuda")
    resident.match_batch(torch.from_numpy(left).cuda(),
                         torch.from_numpy(right).cuda())
    assert resident.upload_bytes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("host_fed", [False, True])
def test_every_device_operation_belongs_to_a_stage_on_card(cuda, host_fed):
    """The program draws nothing on the device's timeline; each operation
    of a call is launched inside one of its stage spans."""
    from torch.autograd import DeviceType

    engine = SGMEngine(SGMOptions(max_disparity=DMAX), device="cuda")
    left, right = pair(2)
    if not host_fed:
        left, right = torch.from_numpy(left).cuda(), torch.from_numpy(right).cuda()
    want = engine.match_batch(left, right).cpu()
    win = stage_breakdown.profiled_window(engine, left, right, 3, host_fed,
                                          None)
    assert all(torch.equal(out.cpu(), want) for out in win.outputs)
    p = win.profile
    started = {e.correlation for e in p.host}
    assert p.device and all(op.correlation in started for op in p.device)
    stages = stage_breakdown.stage_summary(win)
    want_stages = ALL_STAGES if host_fed else ALL_STAGES[1:]
    assert list(stages) == want_stages + ["sgm.match"]
    assert all(s["min"] > 0 for s in stages.values())
    assert win.upload_bytes == (3 * 2 * H * W * 2 if host_fed else 0)
    # census, the horizontal pair's 3 transposes and its path scan, the
    # vertical pair's 2, K3, K4: 9 launches a call (chip_smoke.MAIN_LAUNCHES)
    assert win.launches == 3 * 9 and win.plan_queries > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.match_batch(left, right)
        torch.cuda.synchronize()
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and e.name().startswith("sgm.")]
