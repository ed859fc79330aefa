"""K1, K4 and the WTA of this checkout against another checkout's, on one card.

    python -m soc_project_stereo_matching_tpu_torch.kernel_ab --parent DIR \
        [--reps 20] [--out chiprun_out/kernel_ab.json]

``DIR`` is an unpacked copy of the other commit, for example
``git archive <commit> | tar -x -C build/parent`` (``build/`` is
git-ignored).  Its sources that define ``sgm_remove_speckles``,
``sgm_census_cost`` and ``sgm_wta_reduce`` are built into a library of their
own; those C entries have this checkout's names and signatures.  At the cone
geometry (375x450, D=64, B=2, 8, 32) and at Middlebury-half (1000x1500,
D=256, B=1), on seeded synthetic pairs:

* K4 (``sgm_remove_speckles``, on the engine's pre-speckle disparity) and K1
  (``sgm_census_cost``; at Middlebury-half also in halo mode) of both
  checkouts are held bit-equal to each other and to their plain versions,
  then timed by CUDA events in turns: other, this, this, other (median of
  ``--reps`` launches each);
* each K4 launch's device time by kernel, from ``torch.profiler``, for both
  checkouts (the parent's union pass against its flatten, the new tile,
  border, flatten and verdict kernels);
* the cluster design of the speckle probes, S1 ``pyr`` + S4 ``fused_agg``
  (``probes/kernels.py``), beside this checkout's K4;
* K1's ablations: this checkout's source with the census window replaced
  by its centre pixel, the popcounts by a constant, or the 16-byte stores
  left out (each a text patch; a patch that no longer applies is reported
  as such), and ``Tensor.fill_`` on the same volume, a PyTorch call that
  writes the same bytes and nothing else;
* the WTA (``sgm_wta_reduce``, both views, on the volume this checkout's
  ``aggregate_paths`` makes of the pair) of both checkouts, held bit-equal
  to each other and to the plain version, then timed in turns as above,
  a call at a time and, since a call's events also hold host time while
  the card waits, a launch at a time in runs of ``RUN`` back-to-back
  launches, beside its byte bound; this checkout's forward view alone and its
  ablations: the reduction replaced by one xor a plane (the staging and
  the loads are left), and the copies left out (the reduction on whatever
  the buffers hold: the compute alone; whole-row blocks only);
* K3 (``lr_check``) on the two views' disparities: its device time from
  ``torch.profiler`` beside its byte bound (12 bytes a pixel).

Needs one CUDA device; prints one line per figure with the card's name and
power limit and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from . import _build
from .config import SGMOptions
from .data.synthetic import synthetic_pair
from .ops import kernels, postprocess
from .ops.wta import WTAPlanes, finalize_disparity
from .probes import kernels as pk
from .probes import prespeckle_disparity
from .utils.profiling import card

ENTRIES = ("sgm_remove_speckles", "sgm_census_cost", "sgm_wta_reduce")
SHAPES = (("cone B=2", 2, 375, 450, 64), ("cone B=8", 8, 375, 450, 64),
          ("cone B=32", 32, 375, 450, 64),
          ("Middlebury-half B=1", 1, 1000, 1500, 256))
# K1 ablations: (text in csrc/census_cost.cu, its replacement)
ABLATIONS = {
    "no census window": [
        ("census_at(slab_l, W, w, border_row)", "(int)slab_l[2 * W + w]"),
        ("census_at(slab_r, W, w, border_row)", "(int)slab_r[2 * W + w]")],
    "no popcounts": [("(uint8_t)__popc(codes_l[w] ^ r[w])", "(uint8_t)w")],
    "no 16-byte stores": [
        ("*reinterpret_cast<uint4*>(base + c) =",
         "if (c < 0) *reinterpret_cast<uint4*>(base + c) =")],
}
# WTA ablations: (text in csrc/wta.cu, its replacement)
WTA_ABLATIONS = {
    "wta loads only": [
        ("__device__ __forceinline__ void pair_step(Pair& p, unsigned vp, int v0,\n"
         "                                          int v1, int k) {\n",
         "__device__ __forceinline__ void pair_step(Pair& p, unsigned vp, int v0,\n"
         "                                          int v1, int k) {\n"
         "  p.m1 ^= vp + v0 + v1;\n  return;\n")],
    "wta no copies": [
        ("        mbar_expect(smem_addr(full + b), bytes);\n"
         "        bulk_copy(smem_addr(smem + base), (const unsigned char*)g - lead,\n"
         "                  bytes, smem_addr(full + b));",
         "        mbar_expect(smem_addr(full + b), 0);")],
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
RUN = 10    # back-to-back WTA launches between two events


def patched(text: str, edits) -> str | None:
    """``text`` with each (old, new) replaced once, or None if an ``old`` is
    not in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return text


def build_library(name: str, sources: dict) -> ctypes.CDLL:
    """Compile {file name: source text} into one library under
    ``build/kernel_ab/`` (keyed by the texts) and load it."""
    digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for fname, text in sorted(sources.items()):
        digest.update(fname.encode() + text.encode())
    out = (_build.BUILD_DIR.parent / "kernel_ab"
           / f"{name}-{digest.hexdigest()[:12]}")
    lib = out / "lib.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        paths = []
        for fname, text in sources.items():
            (out / fname).write_text(text)
            paths.append(str(out / fname))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", str(lib), *paths], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        if hasattr(handle, entry):
            getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
            getattr(handle, entry).restype = ctypes.c_int
    return handle


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k4(lib, disp, area):
    b, h, w = disp.shape
    out = torch.empty_like(disp)
    label = torch.empty(disp.shape, dtype=torch.int32, device=disp.device)
    count = torch.empty_like(label)
    if lib.sgm_remove_speckles(disp.data_ptr(), out.data_ptr(),
                               label.data_ptr(), count.data_ptr(), b, h, w,
                               1.0, area, _stream()):
        raise RuntimeError("sgm_remove_speckles failed")
    return out


def k1(lib, left, right, dmax, halo=False):
    b, h, w = left.shape
    h -= 4 * halo
    out = torch.empty((b, h, dmax, w), dtype=torch.uint8, device=left.device)
    if lib.sgm_census_cost(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                           b, h, w, 0, dmax, int(halo), _stream()):
        raise RuntimeError("sgm_census_cost failed")
    return out


def wta(lib, aggr, dmin: int, inverse: bool = True):
    b, h, d, w = aggr.shape
    out = torch.empty((10 if inverse else 5, b, h, w), dtype=torch.int32,
                      device=aggr.device)
    if lib.sgm_wta_reduce(aggr.data_ptr(), out.data_ptr(), b, h, d, w, dmin,
                          int(inverse), _stream()):
        raise RuntimeError("sgm_wta_reduce failed")
    return out


def sources_defining(csrc: Path, entries) -> dict:
    """{file name: text} of the sources in ``csrc`` that define the C
    entries (each must be defined somewhere)."""
    out = {}
    for entry in entries:
        found = [src for src in sorted(csrc.glob("*.cu"))
                 if f'extern "C" int {entry}(' in src.read_text()]
        if not found:
            raise SystemExit(f"kernel_ab: no source in {csrc} defines {entry}")
        out[found[0].name] = found[0].read_text()
    return out


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns: dict, reps: int) -> dict:
    """{name: [ms, ms]}: each timed twice, in the order a, b, b, a."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(event_ms(fns[name], reps))
    return out


def kernel_name(key: str) -> str:
    """The bare function name of a profiler's kernel key, e.g. ``void
    (anonymous namespace)::tile_kernel(float const*, ...)`` -> tile_kernel."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1].strip()


def kernel_ms(fn, calls: int = 5) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if not total:
            continue
        out[kernel_name(evt.key)] = (out.get(kernel_name(evt.key), 0.0)
                                     + total / 1e3 / calls)
    return out


def same(got, want, what: str) -> None:
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"{what}: results differ")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked checkout of the commit to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    csrc_other = (Path(args.parent) / "soc_project_stereo_matching_tpu_torch"
                  / "csrc")
    other = build_library("parent", sources_defining(csrc_other, ENTRIES))
    this = _build.load()
    wta_text = (_build.CSRC / "wta.cu").read_text()
    wta_ablated = {name: patched(wta_text, edits)
                   for name, edits in WTA_ABLATIONS.items()}
    wta_ablated = {name: None if text is None else
                   build_library(name.replace(" ", "-"), {"wta.cu": text})
                   for name, text in wta_ablated.items()}
    k1_text = (_build.CSRC / "census_cost.cu").read_text()
    ablated = {name: patched(k1_text, edits)
               for name, edits in ABLATIONS.items()}
    ablated = {name: None if text is None else
               build_library("k1-" + name.replace(" ", "-"),
                             {"census_cost.cu": text})
               for name, text in ablated.items()}
    dev = torch.device("cuda")
    result = {"card": ", ".join(card()), "shapes": {}}
    print(result["card"])

    for label, b, h, w, dmax in SHAPES:
        rec = result["shapes"].setdefault(label, {})
        opt, disp = prespeckle_disparity(dev, b, h, w, dmax)
        area = opt.min_speckle_area
        want = postprocess.remove_speckles(disp, 1.0, area)
        for name, lib in (("parent", other), ("this", this)):
            same(k4(lib, disp, area), want, f"K4 {name} {label}")
        rec["k4_ms"] = in_turns({
            "parent": lambda: k4(other, disp, area),
            "this": lambda: k4(this, disp, area)}, args.reps)
        rec["k4_kernels_ms"] = {
            name: kernel_ms(lambda lib=lib: k4(lib, disp, area))
            for name, lib in (("parent", other), ("this", this))}
        labels, _ = pk.speckle_labels(disp, 1.0, "pyr")
        same(labels, pk.flat_to_root_labels(kernels.union_find_labels(disp)),
             f"S1 pyr labels {label}")
        grouped, h_hist, lo_bits = pk.group_labels(disp, labels, area)
        verdict = pk.speckle_tail_fused(grouped, area, h_hist, lo_bits, True)
        same(pk.apply_verdict(disp, pk.ungroup_verdict(verdict, h, w)), want,
             f"S1 pyr + S4 fused_agg {label}")
        rec["cluster_design_ms"] = {
            "pyr": event_ms(lambda: pk.speckle_labels(disp, 1.0, "pyr"),
                            args.reps),
            "fused_agg": event_ms(lambda: pk.speckle_tail_fused(
                grouped, area, h_hist, lo_bits, True), args.reps)}
        ms = {name: statistics.median(v) for name, v in rec["k4_ms"].items()}
        print(f"{label} K4 ms parent {rec['k4_ms']['parent']} this "
              f"{rec['k4_ms']['this']} ({ms['parent'] / ms['this']:.1f}x); "
              f"by kernel {json.dumps(rec['k4_kernels_ms'])}; S1 pyr + S4 "
              f"fused_agg {json.dumps(rec['cluster_design_ms'])}")
        del disp, want, labels, grouped, verdict

        levels = tuple(dmax * f // 64 for f in (10, 20, 35))
        left, right, _ = synthetic_pair(2, b, h, w, levels)
        left, right = (torch.from_numpy(x).to(dev) for x in (left, right))
        runs = {"untiled": (left, right, False)}
        if h == 1000:       # the tiled engine's halo census on a 1x1 mesh
            runs["halo"] = tuple(torch.nn.functional.pad(x, (0, 0, 2, 2))
                                 for x in (left, right)) + (True,)
        bound = (2 * b * h * w + b * h * w * dmax) / HBM_BYTES_PER_S * 1e3
        rec["k1_bound_ms"] = bound
        for mode, (il, ir, halo) in runs.items():
            want = kernels.census_cost_volume_plain(il, ir, 0, dmax, halo)
            for name, lib in (("parent", other), ("this", this)):
                same(k1(lib, il, ir, dmax, halo), want, f"K1 {name} {label}")
            ms = rec[f"k1_{mode}_ms"] = in_turns({
                "parent": lambda: k1(other, il, ir, dmax, halo),
                "this": lambda: k1(this, il, ir, dmax, halo)}, args.reps)
            print(f"{label} K1 {mode} ms parent {ms['parent']} this "
                  f"{ms['this']}, bound {bound:.4f} ms")
        vol = k1(this, left, right, dmax)
        abl = {name: None if lib is None else
               event_ms(lambda lib=lib: k1(lib, left, right, dmax), args.reps)
               for name, lib in ablated.items()}
        abl["Tensor.fill_ of the volume"] = event_ms(lambda: vol.fill_(7),
                                                     args.reps)
        rec["k1_ablations_ms"] = abl
        print(f"{label} K1 ablations ms {json.dumps(abl)}")
        del runs, vol

        # the WTA on the volume the main path's scans make, then K3
        opt = SGMOptions(max_disparity=dmax)
        aggr = kernels.aggregate_paths(
            kernels.census_cost_volume(left, right, 0, dmax), left, opt)
        want = torch.stack(sum(kernels.wta_reduce_plain(aggr, opt, True), ()))
        for name, lib in (("parent", other), ("this", this)):
            same(wta(lib, aggr, 0), want, f"WTA {name} {label}")
        del want
        px, vol = b * h * w, b * h * w * dmax
        rec["wta_bound_ms"] = (2 * vol + 40 * px) / HBM_BYTES_PER_S * 1e3
        ms = rec["wta_ms"] = in_turns({
            "parent": lambda: wta(other, aggr, 0),
            "this": lambda: wta(this, aggr, 0)}, args.reps)
        rec["wta_run_ms"] = {name: [t / RUN for t in v] for name, v in in_turns({
            "parent": lambda: [wta(other, aggr, 0) for _ in range(RUN)],
            "this": lambda: [wta(this, aggr, 0) for _ in range(RUN)]},
            args.reps).items()}
        extra = {"forward view alone": event_ms(
            lambda: wta(this, aggr, 0, False), args.reps)}
        extra.update({name: None if lib is None else
                      event_ms(lambda lib=lib: wta(lib, aggr, 0), args.reps)
                      for name, lib in wta_ablated.items()})
        extra["aggr.amin(dim=2), a read of the volume"] = event_ms(
            lambda: aggr.view(torch.int16).amin(dim=2), args.reps)
        rec["wta_ablations_ms"] = extra
        run = rec["wta_run_ms"]
        print(f"{label} WTA ms parent {ms['parent']} this {ms['this']}; a "
              f"launch in runs of {RUN}: parent {run['parent']} this "
              f"{run['this']}; bound {rec['wta_bound_ms']:.4f} ms; "
              f"{json.dumps(extra)}")
        planes = wta(this, aggr, 0)
        dl = finalize_disparity(WTAPlanes(*planes[:5]), opt)
        dr = finalize_disparity(WTAPlanes(*planes[5:]), opt)
        k3 = lambda: kernels.lr_check(dl, dr, opt.lrcheck_thres, dmax)
        rec["k3_bound_ms"] = 12 * px / HBM_BYTES_PER_S * 1e3
        rec["k3_kernels_ms"] = kernel_ms(k3)
        rec["k3_event_ms"] = event_ms(k3, args.reps)
        print(f"{label} K3 device ms {json.dumps(rec['k3_kernels_ms'])}, "
              f"events {rec['k3_event_ms']}, bound {rec['k3_bound_ms']:.4f} ms")
        del left, right, aggr, planes, dl, dr
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
