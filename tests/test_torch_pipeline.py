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
from soc_project_stereo_matching_tpu_torch import SGMEngine, config
from soc_project_stereo_matching_tpu_torch.config import from_jax
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
    got = sgm_forward(torch.from_numpy(left), torch.from_numpy(right),
                      from_jax(opt), mode, use_kernels=False).numpy()
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
    opt = config.SGMOptions(max_disparity=16)
    before = dict(kernels.LAUNCHES)
    same(sgm_forward(lt, rt, opt, use_kernels=True),
         sgm_forward(lt, rt, opt, use_kernels=False))
    assert kernels.LAUNCHES == before


def test_any_leading_batch_dims():
    left, right, _ = synthetic_pair(4, 4, H, W, SMALL["levels"])
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    opt = config.SGMOptions(max_disparity=16)
    flat = sgm_forward(lt, rt, opt)
    nested = sgm_forward(lt.reshape(2, 2, H, W), rt.reshape(2, 2, H, W), opt)
    assert nested.shape == (2, 2, H, W)
    same(nested.reshape(4, H, W), flat)
    same(sgm_forward(lt[1], rt[1], opt), flat[1])


def test_engine_on_cpu_takes_numpy_and_returns_f32_tensor():
    left, right, _ = synthetic_pair(5, 2, H, W, SMALL["levels"])
    opt = config.SGMOptions(max_disparity=16)
    engine = SGMEngine(opt, device="cpu")
    batch = engine.match_batch(left, right)
    assert isinstance(batch, torch.Tensor) and batch.dtype == torch.float32
    assert batch.device.type == "cpu" and batch.shape == (2, H, W)
    same(batch, sgm_forward(torch.from_numpy(left), torch.from_numpy(right), opt))
    same(engine.match(left[0], right[0]), batch[0])
    plain = SGMEngine(opt, config.EngineConfig(use_pallas=False), device="cpu")
    same(plain.match(torch.from_numpy(left[1]), right[1]), batch[1])


def test_engine_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGMEngine(config.SGMOptions())


def test_unported_options_raise():
    """Tiling, meshes and ``median_inplace`` run now; what still refuses is
    a mesh that is not the port's (a JAX mesh, say) and a mesh larger than
    the process group (here none)."""
    from soc_project_stereo_matching_tpu.parallel.mesh import make_mesh as j_mesh
    from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh

    for mesh in (object(), j_mesh(1, 1)):
        with pytest.raises(TypeError, match="Mesh"):
            SGMEngine(config=config.EngineConfig(tile_mode="exact"),
                      device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(1, 2)
    engine = SGMEngine(config.SGMOptions(max_disparity=16, median_inplace=True),
                       device="cpu")
    left, right, _ = synthetic_pair(9, 1, H, W, SMALL["levels"])
    got = engine.match(left[0], right[0])
    same(got, oracle.sgm_match(left[0], right[0], engine.options))


def test_port_imports_no_jax():
    """No module of the port loads JAX or any module of the JAX package."""
    pkg = "soc_project_stereo_matching_tpu_torch"
    mods = ["config", "models.sgm", "ops.kernels", "_build", "parallel.mesh",
            "parallel.multihost", "parallel.tiles", "parallel.dryrun",
            "stage_breakdown", "utils.profiling", "probes", "probes.kernels",
            "probes.recurrence_floor", "probes.aggr_transpose",
            "probes.int16_recurrence", "probes.ablation", "probes.speckle",
            "probes.speckle_tail", "probes.__main__"]
    code = ("import sys; import " + ", ".join(f"{pkg}.{m}" for m in mods) + "; "
            "ref = 'soc_project_stereo_matching_tpu'; "
            "bad = sorted(m for m in sys.modules if m.startswith('jax') "
            "or m == ref or m.startswith(ref + '.')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
    for path in [REPO / "chip_smoke.py", *(REPO / pkg).rglob("*.py")]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith("jax"), (path, line)
                assert words[1] != "soc_project_stereo_matching_tpu" and \
                    not words[1].startswith("soc_project_stereo_matching_tpu."), \
                    (path, line)


def test_port_config_mirrors_the_jax_config(tmp_path):
    """Same fields, types and defaults; ``from_jax`` carries every field;
    one YAML file loads in both packages."""
    import dataclasses

    from soc_project_stereo_matching_tpu import config as j_config

    for name in ("SGMOptions", "EngineConfig"):
        ours, theirs = getattr(config, name), getattr(j_config, name)
        assert [(f.name, f.type, f.default) for f in dataclasses.fields(ours)] \
            == [(f.name, f.type, f.default) for f in dataclasses.fields(theirs)]
    assert config.INVALID_FLOAT == j_config.INVALID_FLOAT

    j_opt = SGMOptions(num_paths=4, min_disparity=8, max_disparity=56,
                       uniqueness_ratio=0.95, min_speckle_area=8, p1=7,
                       median_inplace=True)
    j_eng = EngineConfig(use_pallas=False, tile_mode="pipelined",
                         diagonal_mode="restart", compute16=True)
    opt, eng = from_jax(j_opt), from_jax(j_eng)
    assert type(opt) is config.SGMOptions and type(eng) is config.EngineConfig
    assert dataclasses.asdict(opt) == dataclasses.asdict(j_opt)
    assert dataclasses.asdict(eng) == dataclasses.asdict(j_eng)
    assert from_jax(opt) == opt and hash(from_jax(opt)) == hash(opt)
    assert opt.disp_range == j_opt.disp_range
    assert j_config.SGMOptions(**opt.to_dict()) == j_opt       # and back
    with pytest.raises(TypeError):
        from_jax({"p1": 3})
    for bad in (dict(min_disparity=-1), dict(max_disparity=0),
                dict(num_paths=5), dict(p1=-1)):
        with pytest.raises(ValueError):
            config.SGMOptions(**bad)
    with pytest.raises(ValueError):
        config.EngineConfig(tile_mode="ring")
    with pytest.raises(ValueError, match="unknown SGMOptions"):
        config.SGMOptions.from_dict({"p3": 1})

    ours, theirs = tmp_path / "ours.yaml", tmp_path / "theirs.yaml"
    config.save_yaml_config(ours, opt, eng)
    j_config.save_yaml_config(theirs, j_opt, j_eng)
    assert ours.read_text() == theirs.read_text()
    assert j_config.load_yaml_config(ours) == (j_opt, j_eng)
    assert config.load_yaml_config(theirs) == (opt, eng)
    ours.write_text("engine: {tile: 2}\n")
    with pytest.raises(ValueError, match="unknown EngineConfig"):
        config.load_yaml_config(ours)


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
