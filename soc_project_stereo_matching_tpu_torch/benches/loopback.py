"""Frames/s of the reference wire protocol over localhost TCP — the port's
counterpart of ``scripts/compat_loopback_fps.py``.

    python -m soc_project_stereo_matching_tpu_torch.benches loopback \
        [--device cuda|cpu] [--out chiprun_out/loopback.json]

Two numbers, each read from the ``CompatServer``'s stats file (frames over
the sum of the frames' round trips, the server's clock), at the firmware's
1280x720 frame:

* ``wire_only_fps``: a client that echoes a precomputed depth plane, the
  protocol alone (encode, stream, decode and the server's scoring), over the
  frames eight times;
* ``engine_fps``: ``compat/client.run_client`` with an
  ``SGMEngine(SGMOptions(max_disparity=64))`` on the card (the JAX script
  forces the CPU there; here ``--device cpu`` does) and
  ``calib_every_frame=True``, over the frames twice; the engine has matched
  one frame before, so that the kernels' build and the allocator's first
  requests fall outside the server's clock.

The frames are a Middlebury-2014 layout of seeded synthetic pairs written
into a temporary folder by ``data/convert`` (the JAX script reads the
reference's four pairs, ``data/datasets.reference_data_pairs``).  The stats file is
written when the client's handler ends: it is polled with a deadline.  On
the CPU the frame counts and the measurements are checked and every rate
is None.
"""

from __future__ import annotations

import json
import socket
import struct
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import SGMEngine, SGMOptions
from ..compat import protocol as proto
from ..compat.client import run_client
from ..compat.server import CompatServer
from ..data import convert, datasets, synthetic
from . import (SEED, document, fmt, levels, log, out_path, resolve_device,
               write)

W, H, D = 1280, 720, 64
FRAMES = 4                  # the reference's four pairs (:97)
WIRE_REPEAT, ENGINE_REPEAT = 8, 2       # :101, :114
CALIB = dict(fx=1400.0, baseline=120.0, doffs=4.0)
STATS_TIMEOUT_S = 120.0
CPU_SHAPE = dict(frames=2, h=32, w=64, dmax=16)


def frame_data(frames: int, h: int, w: int, dmax: int, seed: int = SEED):
    """(left, right, field, calib) of the loopback's frames: uint8
    (frames, H, W) twice, the int (H, W) true disparity, the calibration."""
    left, right, field = synthetic.synthetic_pair(seed, frames, h, w,
                                                  levels(0, dmax))
    return left, right, field, datasets.synthetic_calib(w, h, **CALIB)


def write_frames(root: Path, left, right, field, calib, dmax: int) -> list:
    """``frame_data``'s frames as Middlebury-2014 folders under ``root``."""
    return [convert.pair_to_middlebury2014(
        synthetic.stereo_pair(f"loop{i}", left[i], right[i], field, calib,
                              dmax), root / f"loop{i}")
        for i in range(len(left))]


def collect_new_stats(stats_dir: Path, before: set,
                      timeout_s: float = STATS_TIMEOUT_S) -> dict:
    """The first stats file in ``stats_dir`` not in ``before``, parsed;
    raises after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        new = [p for p in stats_dir.glob("*.txt") if p not in before]
        if new:
            try:
                return json.loads(new[0].read_text())
            except json.JSONDecodeError:
                pass            # being written
        if time.monotonic() >= deadline:
            raise TimeoutError(f"no stats file appeared in {stats_dir} "
                               f"within {timeout_s} s")
        time.sleep(0.05)


def run_echo_client(host: str, port: int) -> int:
    """Protocol-only client: sends back one precomputed depth plane a frame;
    returns the frames it answered."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.connect((host, port))
    frames, depth = 0, None
    try:
        while True:
            sock.sendall(struct.pack("<B", proto.REQ_IMG_CALIB))
            header, _, left_bgr, _ = proto.recv_stereo_frame(sock)
            if header.type_id == proto.REQ_CLOSE:
                break
            if depth is None or depth.shape != left_bgr.shape[:2]:
                depth = np.full(left_bgr.shape[:2], 1000.0, np.float32)
            proto.send_depth_image(sock, header.seq, depth)
            frames += 1
    finally:
        sock.close()
    return frames


def serve(dirs: list, h: int, w: int, stats_dir: Path, client) -> tuple:
    """(frames ``client(port)`` reports, the server's stats) of one
    loopback run over ``dirs``."""
    stats_dir.mkdir(parents=True, exist_ok=True)
    server = CompatServer(dirs, host="127.0.0.1", port=0, width=w, height=h,
                          stats_dir=stats_dir)
    port = server.start()
    try:
        before = set(stats_dir.glob("*.txt"))
        frames = client(port)
        stats = collect_new_stats(stats_dir, before)
    finally:
        server.stop()
    return frames, stats


def run(device=None, frames=None, wire_repeat=WIRE_REPEAT,
        engine_repeat=ENGINE_REPEAT) -> dict:
    """Both loopbacks over ``frames`` distinct frames; the sizes are
    ``FRAMES`` at 1280x720 D=64 on the card and ``CPU_SHAPE`` on the CPU.
    Raises if a client's frame count or the server's differs from the
    frames served."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    shape = dict(frames=FRAMES, h=H, w=W, dmax=D) if cuda else dict(CPU_SHAPE)
    if frames is not None:
        shape["frames"] = frames
    h, w, dmax = shape["h"], shape["w"], shape["dmax"]
    data = frame_data(shape["frames"], h, w, dmax)
    engine = SGMEngine(SGMOptions(max_disparity=dmax), device=device)
    engine.match(data[0][0], data[1][0])    # the build and the allocator
    with tempfile.TemporaryDirectory(prefix="loopback_") as tmp:
        tmp = Path(tmp)
        dirs = write_frames(tmp / "frames", *data, dmax)
        wire_n, wire_stats = serve(dirs * wire_repeat, h, w, tmp / "wire_stats",
                             lambda port: run_echo_client("127.0.0.1", port))
        engine_n, engine_stats = serve(
            dirs * engine_repeat, h, w, tmp / "engine_stats",
            lambda port: run_client("127.0.0.1", port, engine=engine,
                                    calib_every_frame=True))
    for what, n, stats, want in (
            ("wire", wire_n, wire_stats, wire_repeat),
            ("engine", engine_n, engine_stats, engine_repeat)):
        want *= shape["frames"]
        if n != want or stats["total_frames"] != want:
            raise AssertionError(f"loopback {what}: client {n} frames, server "
                                 f"{stats['total_frames']}, want {want}")
    rate = lambda stats: stats["fps"] if cuda else None
    doc = document(
        "loopback", device,
        format=f"{w}x{h} frames over localhost TCP, D={dmax}",
        frames=shape["frames"], wire_frames=wire_n, engine_frames=engine_n,
        engine_calls=1 + engine_n,
        wire_only_fps=rate(wire_stats),
        engine_fps=rate(engine_stats),
        engine_ms_per_frame=(engine_stats["total_time_s"] / engine_n * 1e3
                             if cuda else None),
        engine_measurements=[{k: m[k] for k in ("seq", "rmse_mm", "bpr",
                                                "n_valid")}
                             for m in engine_stats["measurements"]],
        wire_only_note="precomputed-depth echo client: protocol encode, "
                       "stream and decode and the server's scoring only",
        engine_note="compat client with SGMEngine on the device named here, "
                    "calibration requested with every frame; the server's "
                    "clock, frame sent to depth received")
    log(f"loopback: {doc['card']}, {doc['power_limit']}; {doc['format']}")
    log(f"wire only: {wire_n} frames, {fmt(doc['wire_only_fps'])} frames/s; "
        f"engine: {engine_n} frames, {fmt(doc['engine_fps'])} frames/s, "
        f"{fmt(doc['engine_ms_per_frame'])} ms a frame")
    return doc


def main(args) -> int:
    path = out_path("loopback", args.out)
    write(run(args.device), path)
    log(f"wrote {path}")
    return 0
