"""The port's sharded engine across four gloo ranks on the CPU vs the JAX
tiled matcher on the same mesh shape, bit for bit (inf equal to inf).

Per mesh shape, (data=2, tile=2) and (1, 4), one run of four OS processes
(they import no JAX) matches one seeded (4, 16, 64) batch at D=16 in every
schedule: exact, pipelined, local, ``tile_mode='none'`` (data parallel),
exact with the in-place median, and exact on the plain path; rank 0 writes
the results to an ``.npz``.  Every collective and hop has a 60 s timeout and
each process 300 s, so a hang fails the test instead of stalling the run.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from soc_project_stereo_matching_tpu import EngineConfig, SGMOptions
from soc_project_stereo_matching_tpu.models.sgm import SGMEngine as JEngine
from soc_project_stereo_matching_tpu.parallel import mesh as j_mesh
from soc_project_stereo_matching_tpu.parallel import tiles as j_tiles
from soc_project_stereo_matching_tpu_torch import SGMEngine
from soc_project_stereo_matching_tpu_torch.config import from_jax

REPO = Path(__file__).resolve().parents[1]
H, W, B = 16, 64, 4
OPTS = SGMOptions(max_disparity=16, min_speckle_area=8)
MESHES = [(2, 2), (1, 4)]
RUNS = {  # name -> (tile_mode, median_inplace, use_pallas)
    "exact": ("exact", False, True),
    "pipelined": ("pipelined", False, True),
    "local": ("local", False, True),
    "none": ("none", False, True),
    "exact_inplace": ("exact", True, True),
    "exact_plain": ("exact", False, False),
}

WORKER = r"""
import ast, dataclasses, sys
from datetime import timedelta

import numpy as np

from soc_project_stereo_matching_tpu_torch import (EngineConfig, SGMEngine,
                                                   SGMOptions)
from soc_project_stereo_matching_tpu_torch.parallel import multihost
from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

rank, port, data, tile = map(int, sys.argv[1:5])
inputs, out, runs = sys.argv[5], sys.argv[6], ast.literal_eval(sys.argv[7])
timeout = timedelta(seconds=60)
multihost.initialize(f"tcp://127.0.0.1:{port}", data * tile, rank, "gloo",
                     timeout=timeout)
assert not any(m.startswith("jax") or m == "soc_project_stereo_matching_tpu"
               or m.startswith("soc_project_stereo_matching_tpu.")
               for m in sys.modules)
mesh = make_mesh(data, tile, timeout=timeout)
assert mesh.shape == {"data": data, "tile": tile} and mesh.rank == rank
pair = np.load(inputs)
opts = SGMOptions(max_disparity=16, min_speckle_area=8)
res = {}
for name, (mode, inplace, use_pallas) in runs.items():
    engine = SGMEngine(dataclasses.replace(opts, median_inplace=inplace),
                       EngineConfig(tile_mode=mode, use_pallas=use_pallas),
                       device="cpu", mesh=mesh)
    res[name] = engine.match_batch(pair["left"], pair["right"]).numpy()
metrics = multihost.allsum_metrics({"n": 10, "err": rank + 0.5})
res["metrics"] = np.array([metrics["err"], metrics["n"]])
res["local_batch"] = np.array(multihost.process_local_batch(8))
if rank == 0:
    np.savez(out, **res)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    return (rng.integers(0, 256, (B, H, W), dtype=np.uint8),
            rng.integers(0, 256, (B, H, W), dtype=np.uint8))


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory, pair):
    """Both mesh shapes' runs, four processes each, started together."""
    tmp = tmp_path_factory.mktemp("gloo")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, left=pair[0], right=pair[1])
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}
    procs = {}
    for data, tile in MESHES:
        port, out = _free_port(), tmp / f"mesh_{data}x{tile}.npz"
        procs[(data, tile)] = out, [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(port), str(data),
             str(tile), str(inputs), str(out), repr(RUNS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for rank in range(data * tile)]
    results = {}
    try:
        for shape, (out, ranks) in procs.items():
            logs = [p.communicate(timeout=300)[0] for p in ranks]
            for rank, (p, log) in enumerate(zip(ranks, logs)):
                assert p.returncode == 0, f"mesh {shape} rank {rank}:\n{log}"
            results[shape] = dict(np.load(out))
    finally:
        for _, ranks in procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return results


@pytest.fixture(scope="module")
def jax_result(pair):
    """The JAX result of a run on a mesh shape (its jnp tiled path; the
    port's plain and kernel paths share one)."""
    cache = {}

    def result(shape, name):
        mode, inplace, _ = RUNS[name]
        if (shape, mode, inplace) not in cache:
            opts = dataclasses.replace(OPTS, median_inplace=inplace)
            mesh = j_mesh.make_mesh(*shape)
            if mode == "none":
                matcher = JEngine(opts, EngineConfig(use_pallas=False),
                                  mesh=mesh).match_batch
            else:
                matcher = j_tiles.make_tiled_matcher(opts, mesh, H, W,
                                                     cross_tile=mode)
            cache[shape, mode, inplace] = np.asarray(matcher(*pair))
        return cache[shape, mode, inplace]

    return result


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gloo_ranks_match_jax_tiled_matcher(gloo_results, jax_result, shape,
                                            name):
    got = gloo_results[shape][name]
    assert got.dtype == np.float32 and got.shape == (B, H, W)
    np.testing.assert_array_equal(got, jax_result(shape, name))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gloo_exact_schedules_equal_untiled_and_local_differs(gloo_results,
                                                              pair, shape):
    res = gloo_results[shape]
    untiled = SGMEngine(from_jax(OPTS), device="cpu").match_batch(*pair).numpy()
    for name in ("exact", "pipelined", "none", "exact_plain"):
        np.testing.assert_array_equal(res[name], untiled)
    assert not np.array_equal(res["local"], untiled)   # tiles restart paths
    np.testing.assert_array_equal(res["metrics"], [0.5 + 1.5 + 2.5 + 3.5, 40])
    assert int(res["local_batch"]) == 2


def test_dryrun_multichip_runs_gloo_ranks_only_when_asked():
    """``--device cpu`` runs the sweep on two gloo ranks; without it the dry
    run means NCCL and refuses when the cards are missing."""
    import torch

    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}
    cmd = [sys.executable, "-m",
           "soc_project_stereo_matching_tpu_torch.parallel.dryrun", "2"]
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multichip OK: 2 ranks over gloo, 3 schedule/mesh" in proc.stdout
    if torch.cuda.device_count() < 2:
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0 and "2 ranks need 2 cards" in proc.stderr
