"""The port's SGM slice end to end vs the JAX pipeline (jnp ops and the
Pallas path in interpret mode) and the numpy oracle, bit for bit (inf equal
to inf), on seeded synthetic shifted pairs; plus the engine's contract and
the port's import isolation from JAX.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_project_stereo_matching_tpu import EngineConfig, SGMOptions, oracle
from soc_project_stereo_matching_tpu.models import sgm as j_sgm
from soc_project_stereo_matching_tpu_torch import SGMEngine
from soc_project_stereo_matching_tpu_torch.data.synthetic import synthetic_pair
from soc_project_stereo_matching_tpu_torch.models.sgm import sgm_forward
from soc_project_stereo_matching_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
H, W = 37, 53
SMALL = dict(max_disparity=16, levels=(3, 6, 10))
OFFSET = dict(min_disparity=8, max_disparity=56, levels=(14, 20, 30))


def same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def run(cfg, seed=0, batch=2, mode="wrap", **overrides):
    """(port output, left, right, options) for one synthetic pair."""
    cfg = dict(cfg)
    left, right, _ = synthetic_pair(seed, batch, H, W, cfg.pop("levels"))
    opt = SGMOptions(**cfg, **overrides)
    got = sgm_forward(torch.from_numpy(left), torch.from_numpy(right), opt,
                      mode, use_kernels=False).numpy()
    return got, left, right, opt


@pytest.mark.parametrize("min_area", [8, 50])
def test_slice_matches_jax_both_paths_and_oracle(min_area):
    got, left, right, opt = run(SMALL, min_speckle_area=min_area)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    same(got, j_sgm.sgm_forward(jl, jr, opt, use_pallas=False),
         j_sgm.sgm_forward(jl, jr, opt, use_pallas=True),
         np.stack([oracle.sgm_match(a, b, opt) for a, b in zip(left, right)]))
    # the LR check and the speckle filter each kill pixels here
    no_lr, *_ = run(SMALL, min_speckle_area=min_area, is_check_lr=False)
    no_sp, *_ = run(SMALL, min_speckle_area=min_area, is_remove_speckles=False)
    n_inf = np.isinf(got).sum()
    assert n_inf > np.isinf(no_lr).sum() and n_inf > np.isinf(no_sp).sum()
    assert np.isfinite(got).mean() > 0.5


def test_slice_offset_disparity_range_matches_jax_and_oracle():
    got, left, right, opt = run(OFFSET, seed=1, min_speckle_area=8)
    same(got, j_sgm.sgm_forward(jnp.asarray(left), jnp.asarray(right), opt),
         np.stack([oracle.sgm_match(a, b, opt) for a, b in zip(left, right)]))


def test_slice_restart_mode_matches_jax():
    got, left, right, opt = run(SMALL, seed=2, mode="restart", num_paths=8)
    same(got, j_sgm.sgm_forward(jnp.asarray(left), jnp.asarray(right), opt,
                                "restart"))


def test_slice_kernel_wrappers_on_cpu_equal_plain_without_launches():
    left, right, _ = synthetic_pair(3, 2, H, W, SMALL["levels"])
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    opt = SGMOptions(max_disparity=16)
    before = dict(kernels.LAUNCHES)
    same(sgm_forward(lt, rt, opt, use_kernels=True),
         sgm_forward(lt, rt, opt, use_kernels=False))
    assert kernels.LAUNCHES == before


def test_any_leading_batch_dims():
    left, right, _ = synthetic_pair(4, 4, H, W, SMALL["levels"])
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    opt = SGMOptions(max_disparity=16)
    flat = sgm_forward(lt, rt, opt)
    nested = sgm_forward(lt.reshape(2, 2, H, W), rt.reshape(2, 2, H, W), opt)
    assert nested.shape == (2, 2, H, W)
    same(nested.reshape(4, H, W), flat)
    same(sgm_forward(lt[1], rt[1], opt), flat[1])


def test_engine_on_cpu_takes_numpy_and_returns_f32_tensor():
    left, right, _ = synthetic_pair(5, 2, H, W, SMALL["levels"])
    opt = SGMOptions(max_disparity=16)
    engine = SGMEngine(opt, device="cpu")
    batch = engine.match_batch(left, right)
    assert isinstance(batch, torch.Tensor) and batch.dtype == torch.float32
    assert batch.device.type == "cpu" and batch.shape == (2, H, W)
    same(batch, sgm_forward(torch.from_numpy(left), torch.from_numpy(right), opt))
    same(engine.match(left[0], right[0]), batch[0])
    plain = SGMEngine(opt, EngineConfig(use_pallas=False), device="cpu")
    same(plain.match(torch.from_numpy(left[1]), right[1]), batch[1])


def test_engine_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGMEngine(SGMOptions())


def test_unported_options_raise():
    """Tiling, meshes and ``median_inplace`` run now; what still refuses is
    a mesh that is not the port's (a JAX mesh, say) and a mesh larger than
    the process group (here none)."""
    from soc_project_stereo_matching_tpu.parallel.mesh import make_mesh as j_mesh
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    for mesh in (object(), j_mesh(1, 1)):
        with pytest.raises(TypeError, match="Mesh"):
            SGMEngine(config=EngineConfig(tile_mode="exact"), device="cpu",
                      mesh=mesh)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(1, 2)
    engine = SGMEngine(SGMOptions(max_disparity=16, median_inplace=True),
                       device="cpu")
    left, right, _ = synthetic_pair(9, 1, H, W, SMALL["levels"])
    got = engine.match(left[0], right[0])
    same(got, oracle.sgm_match(left[0], right[0], engine.options))


def test_port_imports_no_jax():
    code = ("import sys; import soc_project_stereo_matching_tpu_torch.models.sgm, "
            "soc_project_stereo_matching_tpu_torch.ops.kernels, "
            "soc_project_stereo_matching_tpu_torch._build, "
            "soc_project_stereo_matching_tpu_torch.parallel.mesh, "
            "soc_project_stereo_matching_tpu_torch.parallel.multihost, "
            "soc_project_stereo_matching_tpu_torch.parallel.tiles, "
            "soc_project_stereo_matching_tpu_torch.parallel.dryrun; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card, or no port beside it: a non-zero exit and no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_stage_breakdown_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from soc_project_stereo_matching_tpu_torch import stage_breakdown

    with pytest.raises(SystemExit, match="needs a CUDA device"):
        stage_breakdown.main([])
