#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. device: require CUDA; print ``nvidia-smi`` name and power limit;
2. build: compile ``csrc/*.cu`` with nvcc and load it; print the seconds;
3. per kernel: K1-K4 (K2's WTA with and without the inverse view) against
   their plain PyTorch versions on the card, bit for bit, at the cone shape
   (B=2, 375x450, D=64) and an off shape (B=2, 37x53, D=48, dmin=8); median
   CUDA-event times of kernel and plain version at the cone shape;
4. slice: ``SGMEngine(SGMOptions(), device="cuda").match_batch`` on a B=8
   synthetic 375x450 pair, with every launch counter reset before and read
   after; the result must be bit-equal to the plain path on the card, a
   96x160 crop bit-equal to the same engine on the CPU (the plain ops, which
   the CPU tests hold bit-equal to the JAX package and its numpy oracle), and
   most finite pixels within 1 of the pair's true disparity; frames/s at B=32;
5. tile phase (the spatial-tiling path):
   a. kernels: the halo census and the carry-in/out group scan against their
      plain versions, bit for bit, on the H-tiles of the cone shape (B=2,
      K=3 tiles of 125 rows) and of Middlebury-half (1000x1500, D=256, B=1,
      K=4 tiles of 250 rows), both direction groups (all six vertical
      directions of ``DIRECTIONS_8``), wrap and restart.  The tiles are
      chained on the one card in the exact schedule's order, and the chained
      output must equal the untiled kernel's; with the tile-local
      horizontal pair it must sum to ``aggregate_paths``.  Median CUDA-event
      times of kernel and plain version at the cone shape;
   b. engine: ``SGMEngine(..., EngineConfig(tile_mode="exact"),
      mesh=make_mesh(1, 1))`` at Middlebury-half D=256 (counters reset
      before, read after) bit-equal to the untiled kernel engine, and the
      frame time of both; all three tile modes at cone B=8 bit-equal too;
   c. multi-card: with two or more cards, ``dryrun_multichip(2)`` over NCCL
      (tile=2, exact and pipelined); with one card a line says it did not run;
6. the per-kernel JSON line, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Inputs are seeded synthetic pairs (no dataset is needed).  Neither JAX nor
the JAX package is imported here; the port itself loads only that
package's jax-free ``config`` module, for ``SGMOptions``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CONE = dict(batch=2, h=375, w=450, dmin=0, dmax=64, levels=(10, 20, 35))
OFF = dict(batch=2, h=37, w=53, dmin=8, dmax=56, levels=(14, 20, 30))
SLICE_BATCH, FPS_BATCH = 8, 32
TILE_CONE = dict(CONE, k=3)
MIDDLEBURY_HALF = dict(batch=1, h=1000, w=1500, dmin=0, dmax=256,
                       levels=(40, 90, 150, 200), k=4)
GROUPS = (((0, 1, -1), False), ((0, -1, 1), True))   # (rolls, reverse)
CROP = (96, 160)
MIN_GOOD = 0.95     # finite pixels within 1 of the true disparity, at least
PALLAS = "soc_project_stereo_matching_tpu/ops/pallas_kernels.py"
CSRC = "soc_project_stereo_matching_tpu_torch/csrc"
KERNELS = {  # wrapper -> (source, Pallas kernel it replaces)
    "census_cost_volume": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    "aggregate_paths": (f"{CSRC}/aggregate.cu", f"{PALLAS}:500"),
    "wta_reduce": (f"{CSRC}/aggregate.cu", f"{PALLAS}:1073"),
    "lr_check": (f"{CSRC}/lr_check.cu", f"{PALLAS}:1754"),
    "remove_speckles": (f"{CSRC}/speckle.cu", f"{PALLAS}:1306"),
    # the tiled path's modes: mask_rows=False, and the cin_*/cout_* refs
    "census_cost_volume_halo": (f"{CSRC}/census_cost.cu", f"{PALLAS}:1619"),
    "directional_scan_group": (f"{CSRC}/aggregate.cu", f"{PALLAS}:178"),
}
MAIN_PATH = ("census_cost_volume", "aggregate_paths", "wta_reduce", "lr_check",
             "remove_speckles")
TILE_PATH = ("census_cost_volume_halo", "directional_scan_group")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs, after
    one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    """Raise unless ``got`` equals ``want`` exactly (same inf/NaN masks, equal
    finite values); return the max |difference| over finite values (0.0)."""
    import torch

    got, want = got.to(torch.float64), want.to(torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(got), mask(want)):
            raise AssertionError(f"{mask.__name__} masks differ")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    if err != 0.0:
        raise AssertionError(f"values differ, max |err| = {err}")
    return err


def planes_err(got, want) -> float:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def pair(cfg, batch=None, seed=0):
    """(left, right, true disparity) on the card."""
    import torch

    from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair

    left, right, field = synthetic_pair(seed, batch or cfg["batch"], cfg["h"],
                                        cfg["w"], cfg["levels"])
    return tuple(torch.from_numpy(x).cuda() for x in (left, right, field))


def check_kernels(cfg, timed: bool) -> dict:
    """Each kernel vs its plain version at one shape; returns per-wrapper
    {"max_abs_err", "ms", "plain_ms"} (times only if ``timed``)."""
    import dataclasses

    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import (aggregation, kernels,
                                                           postprocess, wta)

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    left, right, _ = pair(cfg)
    out = {}
    before = dict(kernels.LAUNCHES)

    def record(name, err, kernel_fn, plain_fn, plain_reps=3):
        out[name] = {"max_abs_err": err}
        if timed:
            out[name]["ms"] = cuda_ms(kernel_fn, 20)
            out[name]["plain_ms"] = cuda_ms(plain_fn, plain_reps)

    # K1
    cc = lambda: kernels.census_cost_volume(left, right, opt.min_disparity,
                                            opt.max_disparity)
    cc_plain = lambda: kernels.census_cost_volume_plain(
        left, right, opt.min_disparity, opt.max_disparity)
    cost = cc()
    record("census_cost_volume", max_abs_err(cost, cc_plain()), cc, cc_plain)

    # K2 scans: the main path's wrap mode, plus restart and 4 paths off-shape
    modes = [(opt, "wrap")]
    if not timed:
        modes += [(opt, "restart"),
                  (dataclasses.replace(opt, num_paths=4), "wrap")]
    err = max(max_abs_err(kernels.aggregate_paths(cost, left, o, mode).to(torch.int32),
                          aggregation.aggregate_paths(cost, left, o, mode).to(torch.int32))
              for o, mode in modes)
    aggr = kernels.aggregate_paths(cost, left, opt)
    record("aggregate_paths", err,
           lambda: kernels.aggregate_paths(cost, left, opt),
           lambda: aggregation.aggregate_paths(cost, left, opt), plain_reps=1)

    # K2 WTA, with and without the inverse view
    fwd, inv = kernels.wta_reduce(aggr, opt, include_inverse=True)
    pf, pi = kernels.wta_reduce_plain(aggr, opt, include_inverse=True)
    err = max(planes_err(fwd, pf), planes_err(inv, pi))
    only_fwd, none = kernels.wta_reduce(aggr, opt, include_inverse=False)
    if none is not None:
        raise AssertionError("wta_reduce(include_inverse=False) returned planes")
    err = max(err, planes_err(only_fwd, pf))
    record("wta_reduce", err,
           lambda: kernels.wta_reduce(aggr, opt, include_inverse=True),
           lambda: kernels.wta_reduce_plain(aggr, opt, include_inverse=True))

    # K3 on the pipeline's own maps, and off-shape on NaN / -inf / +inf too
    dl = wta.finalize_disparity(fwd, opt)
    dr = wta.finalize_disparity(inv, opt)
    cases = [(dl, dr)]
    if not timed:
        g = torch.Generator().manual_seed(3)
        noisy = []
        for m in (dl, dr):
            m = m.clone()
            r = torch.rand(m.shape, generator=g).to(m.device)
            m[r < 0.05] = float("nan")
            m[(r >= 0.05) & (r < 0.1)] = float("-inf")
            m[(r >= 0.1) & (r < 0.15)] = float("inf")
            m[(r >= 0.15) & (r < 0.2)] += 100.0       # out-of-band shifts
            noisy.append(m)
        cases.append(tuple(noisy))
    err = max(max_abs_err(kernels.lr_check(a, b, opt.lrcheck_thres, opt.max_disparity),
                          postprocess.lr_check(a, b, opt.lrcheck_thres, opt.max_disparity))
              for a, b in cases)
    checked = kernels.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity)
    record("lr_check", err,
           lambda: kernels.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity),
           lambda: postprocess.lr_check(dl, dr, opt.lrcheck_thres, opt.max_disparity))

    # K4 on the checked map, and on a noisy small-integer map
    g = torch.Generator().manual_seed(4)
    rough = torch.randint(0, 8, checked.shape, generator=g).float()
    rough[torch.rand(checked.shape, generator=g) < 0.35] = float("inf")
    err = max(max_abs_err(kernels.remove_speckles(m, 1.0, area),
                          postprocess.remove_speckles(m, 1.0, area))
              for m, area in ((checked, opt.min_speckle_area), (rough.cuda(), 9)))
    record("remove_speckles", err,
           lambda: kernels.remove_speckles(checked, 1.0, opt.min_speckle_area),
           lambda: postprocess.remove_speckles(checked, 1.0, opt.min_speckle_area))

    torch.cuda.synchronize()
    for name in MAIN_PATH:
        if kernels.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"{name}: launch counter did not move")
    return out


def halo_tiles(img, k: int) -> list:
    """The (B, H/K + 4, W) halo images of an image's K H-tiles, with zeros
    beyond the image: what ``halo_exchange_rows`` gives each rank."""
    import torch

    ht = img.shape[1] // k
    padded = torch.nn.functional.pad(img, (0, 0, 2, 2))
    return [padded[:, i * ht:i * ht + ht + 4].contiguous() for i in range(k)]


def chain_group(cost, img, rolls, reverse, p1, p2, restart, k):
    """One direction group over K H-tiles chained in the exact schedule's
    order (tile 0 -> K-1, or K-1 -> 0 for a reverse group): each tile takes
    the upstream tile's carry and boundary gray row.  Each tile's kernel
    output and carry are held against the plain version on the same
    inputs.  Returns (the tiles' outputs concatenated, the max error)."""
    import torch

    from soc_project_stereo_matching_tpu_torch.ops import kernels

    ht = cost.shape[1] // k
    parts, carry, err = [None] * k, None, 0.0
    for i in (range(k - 1, -1, -1) if reverse else range(k)):
        rows = slice(i * ht, (i + 1) * ht)
        prev = None
        if carry is not None:
            edge = (i + 1) * ht if reverse else i * ht - 1
            prev = img[:, edge].contiguous()
        args = (cost[:, rows].contiguous(), img[:, rows].contiguous(), None,
                rolls, reverse, p1, p2, restart)
        kw = dict(carry_in=carry, want_carry=True, prev_gray=prev)
        parts[i], carry = kernels.directional_scan_group(*args, **kw)
        want, want_carry = kernels.directional_scan_group_plain(*args, **kw)
        err = max(err, max_abs_err(parts[i], want), planes_err(carry, want_carry))
    return torch.cat(parts, dim=1), err


def check_tile_kernels(cfg, timed: bool) -> dict:
    """The tiled path's kernel modes vs their plain versions on the K
    H-tiles of one shape; returns per-wrapper {"max_abs_err"} (+ "ms" and
    "plain_ms" for one middle tile if ``timed``)."""
    import torch

    from soc_project_stereo_matching_tpu_torch import SGMOptions
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    opt = SGMOptions(min_disparity=cfg["dmin"], max_disparity=cfg["dmax"])
    dmin, dmax, p1, p2, k = opt.min_disparity, opt.max_disparity, opt.p1, \
        opt.p2_init, cfg["k"]
    left, right, _ = pair(cfg)
    h = left.shape[1]
    ht = h // k
    out = {}
    before = dict(kernels.LAUNCHES)

    # halo census: per tile vs plain; the tiles together equal the untiled
    # volume except the global border rows, which the tiled caller fixes
    err, vols = 0.0, []
    tiles = list(zip(halo_tiles(left, k), halo_tiles(right, k)))
    for tl, tr in tiles:
        vols.append(kernels.census_cost_volume(tl, tr, dmin, dmax,
                                               img_has_halo=True))
        err = max(err, max_abs_err(vols[-1], kernels.census_cost_volume_plain(
            tl, tr, dmin, dmax, img_has_halo=True)))
    cost = kernels.census_cost_volume(left, right, dmin, dmax)
    max_abs_err(torch.cat(vols, dim=1)[:, 2:h - 2], cost[:, 2:h - 2])
    out["census_cost_volume_halo"] = {"max_abs_err": err}

    # group scans with carries: each tile vs plain on the same carry-in; the
    # chain equals the untiled group, and with the tile-local horizontal
    # pair the sum is the main path's aggregate_paths
    err = 0.0
    for restart in (False, True):
        mode = "restart" if restart else "wrap"
        total = kernels.horizontal_partial(cost, left, p1, p2, restart).int()
        for i in range(k):
            rows = slice(i * ht, (i + 1) * ht)
            c, g = cost[:, rows].contiguous(), left[:, rows].contiguous()
            max_abs_err(kernels.horizontal_partial(c, g, p1, p2, restart),
                        total[:, rows])
        for rolls, reverse in GROUPS:
            chained, e = chain_group(cost, left, rolls, reverse, p1, p2,
                                     restart, k)
            err = max(err, e)
            max_abs_err(chained, kernels.directional_scan_group(
                cost, left, None, rolls, reverse, p1, p2, restart))
            total += chained.int()
        max_abs_err(total, kernels.aggregate_paths(cost, left, opt, mode).int())
    out["directional_scan_group"] = {"max_abs_err": err}

    torch.cuda.synchronize()
    for name in TILE_PATH:
        if kernels.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"{name}: launch counter did not move")

    if timed:       # the middle tile, its carry from the tile above
        tl, tr = tiles[1]
        first = slice(0, ht)
        _, carry = kernels.directional_scan_group(
            cost[:, first].contiguous(), left[:, first].contiguous(), None,
            GROUPS[0][0], False, p1, p2, False, want_carry=True)
        args = (cost[:, ht:2 * ht].contiguous(), left[:, ht:2 * ht].contiguous(),
                None, GROUPS[0][0], False, p1, p2, False)
        kw = dict(carry_in=carry, want_carry=True,
                  prev_gray=left[:, ht - 1].contiguous())
        for name, fn, plain in (
                ("census_cost_volume_halo",
                 lambda: kernels.census_cost_volume(tl, tr, dmin, dmax,
                                                    img_has_halo=True),
                 lambda: kernels.census_cost_volume_plain(tl, tr, dmin, dmax,
                                                          img_has_halo=True)),
                ("directional_scan_group",
                 lambda: kernels.directional_scan_group(*args, **kw),
                 lambda: kernels.directional_scan_group_plain(*args, **kw))):
            out[name]["ms"] = cuda_ms(fn, 20)
            out[name]["plain_ms"] = cuda_ms(plain, 3)
    return out


def tile_engine_phase() -> dict:
    """The tiled engine on a 1x1 mesh vs the untiled kernel engine; returns
    the launch counts of its Middlebury-half run."""
    import torch

    from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                       SGMOptions)
    from soc_project_stereo_matching_tpu_torch.ops import kernels
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    big = SGMOptions(max_disparity=MIDDLEBURY_HALF["dmax"])
    left, right, field = pair(MIDDLEBURY_HALF, seed=3)
    untiled = SGMEngine(big, device="cuda")
    tiled = SGMEngine(big, EngineConfig(tile_mode="exact"), device="cuda",
                      mesh=make_mesh(1, 1))
    want = untiled.match_batch(left, right)
    kernels.reset_launch_counts()
    got = tiled.match_batch(left, right)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in TILE_PATH}
    missing = [name for name in TILE_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"tiled path launched no {missing}")
    max_abs_err(got, want)
    valid = torch.isfinite(got)
    good = ((got - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"tiled Middlebury-half: only {good} of the "
                             f"finite pixels lie within 1 of the truth")
    ms = {name: [] for name in ("untiled", "tiled")}
    for name in ("untiled", "tiled", "tiled", "untiled"):
        engine = tiled if name == "tiled" else untiled
        ms[name].append(cuda_ms(lambda: engine.match_batch(left, right), 3))
    print(f"tile engine: exact on a 1x1 mesh bit-equal to the untiled engine "
          f"(1000x1500 D=256 B=1; finite {valid.float().mean().item():.4f}, "
          f"{good:.4f} of them within 1 of the truth); frame "
          f"{min(ms['tiled']):.3f} ms tiled vs {min(ms['untiled']):.3f} ms "
          f"untiled (each the lower of two medians of 3)")

    cone_l, cone_r, _ = pair(CONE, batch=SLICE_BATCH, seed=4)
    want = SGMEngine(SGMOptions(), device="cuda").match_batch(cone_l, cone_r)
    for mode in ("exact", "pipelined", "local"):
        engine = SGMEngine(SGMOptions(), EngineConfig(tile_mode=mode),
                           device="cuda", mesh=make_mesh(1, 1))
        max_abs_err(engine.match_batch(cone_l, cone_r), want)
    print(f"tile engine: exact, pipelined and local on a 1x1 mesh bit-equal "
          f"to the untiled engine (cone B={SLICE_BATCH})")
    return launches


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", file=sys.stderr)

    from soc_project_stereo_matching_tpu_torch import SGMEngine, SGMOptions, _build
    from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
    from soc_project_stereo_matching_tpu_torch.ops import kernels

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    # 3. per kernel
    check_kernels(OFF, timed=False)
    cone = check_kernels(CONE, timed=True)
    for name, rec in cone.items():
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
              f"(cone B=2 375x450 D=64, bit-equal)")

    # 4. slice
    engine = SGMEngine(SGMOptions(), device="cuda")
    left, right, field = pair(CONE, batch=SLICE_BATCH, seed=1)
    kernels.reset_launch_counts()
    disp = engine.match_batch(left, right)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in MAIN_PATH}
    missing = [name for name in MAIN_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if not (disp.is_cuda and disp.dtype == torch.float32
            and disp.shape == left.shape):
        raise AssertionError(f"bad output {disp.dtype} {tuple(disp.shape)} "
                             f"on {disp.device}")
    max_abs_err(disp, sgm_forward(left, right, SGMOptions(), use_kernels=False))
    ch, cw = CROP
    crop_l, crop_r = left[0, :ch, :cw].cpu().numpy(), right[0, :ch, :cw].cpu().numpy()
    max_abs_err(engine.match(crop_l, crop_r).cpu(),
                SGMEngine(SGMOptions(), device="cpu").match(crop_l, crop_r))
    valid = torch.isfinite(disp)
    finite = valid.float().mean().item()
    if not 0.5 < finite < 1.0:
        raise AssertionError(f"finite fraction {finite} is not plausible")
    good = ((disp - field).abs() <= 1.0)[valid].float().mean().item()
    if good < MIN_GOOD:
        raise AssertionError(f"only {good} of the finite pixels lie within 1 "
                             f"of the true disparity (want >= {MIN_GOOD})")
    big_l, big_r, _ = pair(CONE, batch=FPS_BATCH, seed=2)
    ms = cuda_ms(lambda: engine.match_batch(big_l, big_r), 5)
    print(f"slice: bit-equal to the plain path (B={SLICE_BATCH}) and to the "
          f"CPU engine ({ch}x{cw} crop); finite fraction {finite:.4f}, "
          f"{good:.4f} of them within 1 of the truth; "
          f"B={FPS_BATCH}: {ms:.3f} ms/batch = {FPS_BATCH / ms * 1e3:.2f} frames/s")

    # 5. tile phase
    check_tile_kernels(MIDDLEBURY_HALF, timed=False)
    cone.update(check_tile_kernels(TILE_CONE, timed=True))
    for name in TILE_PATH:
        rec = cone[name]
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
              f"ms (one cone tile, B=2 125x450 D=64, bit-equal; also at "
              f"1000x1500 D=256 K=4)")
    launches.update(tile_engine_phase())
    if torch.cuda.device_count() >= 2:
        from soc_project_stereo_matching_tpu_torch.parallel.dryrun import (
            dryrun_multichip)

        dryrun_multichip(2)
    else:
        print("tile phase, multi-card: not run: one CUDA device "
              "(dryrun_multichip(2) needs two)")

    # 6. results
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": cone[name]["max_abs_err"],
         "ms": cone[name]["ms"], "plain_ms": cone[name]["plain_ms"]}
        for name, (src, replaces) in KERNELS.items()]}))
    leaked = {"jax", "soc_project_stereo_matching_tpu.oracle"} & set(sys.modules)
    if leaked:
        raise AssertionError(f"imported {sorted(leaked)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
