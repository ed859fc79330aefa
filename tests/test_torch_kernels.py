"""The port's kernel wrappers (``ops/kernels.py``) vs the JAX Pallas entries
they replace and the numpy oracle.

On the CPU a wrapper runs its plain PyTorch version, so here each wrapper is
held bit for bit (inf equal to inf) against the Pallas entry run as
``test_pallas_kernels.py`` runs it on the CPU (interpret mode) and against
``oracle.py``.  The CUDA kernels themselves run only on a card:
``test_torch_cuda.py`` compares them with the plain versions there.
"""

import ctypes
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions, oracle
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu_torch import _build, kernel_ab
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.ops import kernels, wta

H, W = 37, 53
RANGES = [(0, 16), (8, 56)]          # D=16, and D=48 with dmin=8


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def same_planes(got, want):
    assert len(got) == len(want) == 5
    for g, w_ in zip(got, want):
        same(g.numpy(), w_)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (2, H, W), dtype=np.uint8),
            rng.integers(0, 256, (2, H, W), dtype=np.uint8))


@pytest.fixture
def no_launch():
    """The wrapped calls must stay on the plain path: no counter moves."""
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dmin,dmax", RANGES)
def test_census_cost_volume_matches_pallas_and_oracle(pair, dmin, dmax, no_launch):
    il, ir = pair
    got = kernels.census_cost_volume(t(il), t(ir), dmin, dmax).numpy()
    same(got, pk.census_cost_volume_pallas(jnp.asarray(il), jnp.asarray(ir),
                                           dmin, dmax, block_rows=8),
         np.stack([oracle.hamming_cost_volume(oracle.census_5x5(a),
                                              oracle.census_5x5(b), dmin, dmax)
                   for a, b in zip(il, ir)]))


@pytest.mark.parametrize("paths,mode,dmin,dmax", [
    (8, "wrap", 0, 16), (8, "restart", 0, 16), (4, "wrap", 0, 16),
    (4, "restart", 0, 16), (8, "wrap", 8, 56)])
def test_aggregate_paths_wta_matches_pallas(pair, paths, mode, dmin, dmax,
                                            no_launch):
    il, ir = pair
    opt = SGMOptions(num_paths=paths, min_disparity=dmin, max_disparity=dmax)
    cost = kernels.census_cost_volume(t(il), t(ir), dmin, dmax)
    fwd, inv = kernels.aggregate_paths_wta(cost, t(il), from_jax(opt), mode)
    want_f, want_i = pk.aggregate_paths_wta(jnp.asarray(cost.numpy()),
                                            jnp.asarray(il), opt, mode,
                                            block_rows=8)
    same_planes(fwd, want_f)
    same_planes(inv, want_i)
    if mode == "wrap":                              # the oracle's geometry
        aggr = [oracle.aggregate_paths(c, i, opt) for c, i in zip(cost.numpy(), il)]
        for planes, inverse in ((fwd, False), (inv, True)):
            same(wta.finalize_disparity(planes, from_jax(opt)).numpy(),
                 np.stack([oracle.compute_disparity(a, opt, inverse) for a in aggr]))
    only_f, none = kernels.aggregate_paths_wta(cost, t(il), from_jax(opt), mode,
                                               include_inverse=False)
    assert none is None
    same_planes(only_f, want_f)


def test_aggregate_paths_matches_pallas_full_uint8_domain(no_launch):
    """Costs >= 128 exercise the mod-256 wrap of every path step."""
    rng = np.random.default_rng(8)
    cost = rng.integers(0, 256, (2, H, 16, W), dtype=np.uint8)
    img = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    opt = SGMOptions(max_disparity=16)
    got = kernels.aggregate_paths(t(cost), t(img), from_jax(opt))
    assert got.dtype == torch.uint16
    same(got.numpy(), pk.aggregate_paths(jnp.asarray(cost), jnp.asarray(img),
                                         opt, block_rows=8))


@pytest.mark.parametrize("dmin,dmax", RANGES + [(3, 4)])
def test_wta_reduce_matches_pallas(dmin, dmax, no_launch):
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmax)
    aggr = np.random.default_rng(9).integers(0, 60000, (2, 9, dmax - dmin, 40)
                                             ).astype(np.uint16)
    aggr[0, :, :, :8] = 7                           # ties: first argmin wins
    fwd, inv = kernels.wta_reduce(t(aggr), from_jax(opt), include_inverse=True)
    want_f, want_i = pk.wta_reduce_pallas(jnp.asarray(aggr), opt,
                                          include_inverse=True, block_rows=8)
    same_planes(fwd, want_f)
    same_planes(inv, want_i)
    only_f, none = kernels.wta_reduce(t(aggr), from_jax(opt),
                                      include_inverse=False)
    assert none is None
    same_planes(only_f, want_f)


def _wta_volume(d: int, w: int, pattern: str) -> np.ndarray:
    """A seeded (2, 3, D, W) uint16 volume: "random"; "ties" (costs 0..3,
    so the min repeats inside and across chunks); "flat" (half the columns
    one cost on every plane: the first plane wins); "max" (real costs of
    65535 beside small ones, and a column of 65535 only, beside the inverse
    view's 65535 off the row)."""
    rng = np.random.default_rng(d * 1000 + w)
    shape = (2, 3, d, w)
    if pattern == "ties":
        return rng.integers(0, 4, shape).astype(np.uint16)
    aggr = rng.integers(0, 60000, shape)
    if pattern == "flat":
        aggr[..., : w // 2] = 7
    elif pattern == "max":
        aggr = np.where(rng.random(shape) < 0.4, 65535, aggr % 8)
        aggr[..., 0] = 65535
    return aggr.astype(np.uint16)


@pytest.mark.parametrize("d,dmin,w,chunk,inverse,pattern", [
    (1, 0, 24, 1, True, "random"), (1, 5, 24, 8, False, "max"),
    (3, 0, 17, 1, True, "ties"), (3, 2, 17, 2, True, "max"),
    (16, 0, 40, 8, True, "ties"), (16, 8, 40, 5, True, "flat"),
    (16, 0, 40, 16, False, "random"), (48, 8, 53, 16, True, "random"),
    (48, 0, 53, 7, True, "ties"), (48, 30, 40, 8, True, "max"),
    (256, 0, 24, 16, True, "random"), (256, 3, 24, 1, True, "flat"),
    (256, 0, 24, 100, False, "ties"), (256, 2, 24, 9, True, "max")])
def test_wta_online_plain_matches_pallas_and_plain(d, dmin, w, chunk, inverse,
                                                   pattern, no_launch):
    """The WTA kernel's reduction (``wta_online_plain``: planes staged in
    chunks, packed keys and latches, both views in one pass) against the
    Pallas entry (interpret mode) and ``ops/wta.wta_reduce``, bit for bit:
    D = 1 (sec_min 1<<30) to 256 (D > W), dmin = 0 and > 0 (also with the
    whole inverse view off the row), chunks of 1, of D and that do not
    divide D."""
    opt = SGMOptions(min_disparity=dmin, max_disparity=dmin + d)
    aggr = _wta_volume(d, w, pattern)
    got_f, got_i = kernels.wta_online_plain(t(aggr), from_jax(opt), inverse,
                                            chunk)
    want_f, want_i = pk.wta_reduce_pallas(jnp.asarray(aggr), opt,
                                          include_inverse=inverse,
                                          block_rows=8)
    plain_f, plain_i = kernels.wta_reduce_plain(t(aggr), from_jax(opt), inverse)
    same_planes(got_f, want_f)
    same_planes(got_f, [p.numpy() for p in plain_f])
    if inverse:
        same_planes(got_i, want_i)
        same_planes(got_i, [p.numpy() for p in plain_i])
    else:
        assert got_i is None and want_i is None and plain_i is None
    if d == 1:
        assert (got_f.sec_min == 1 << 30).all()


def test_wta_kernel_width_limit_matches_the_source():
    """The wrapper's row limit and key shift are the kernel's (``kMaxWidth``,
    ``kShift`` in csrc/wta.cu); the transcription refuses D > 256 as the
    wrapper does."""
    text = (_build.CSRC / "wta.cu").read_text()
    assert re.search(r"constexpr int kMaxWidth = (\d+);", text).group(1) == \
        str(kernels.WTA_MAX_WIDTH)
    assert re.search(r"constexpr int kShift = (\d+);", text).group(1) == \
        str(kernels.WTA_KEY_SHIFT)
    with pytest.raises(ValueError, match="1..256"):
        kernels.wta_online_plain(torch.zeros((1, 1, 257, 4), dtype=torch.int32),
                                 from_jax(SGMOptions(max_disparity=257)))


def test_lr_check_matches_pallas_and_oracle(no_launch):
    rng = np.random.default_rng(17)
    dl = rng.uniform(0, 16, (2, 45, 83)).astype(np.float32)
    dr = rng.uniform(0, 16, (2, 45, 83)).astype(np.float32)
    dl[rng.random(dl.shape) < 0.2] = np.inf
    dr[rng.random(dr.shape) < 0.2] = np.inf
    got = kernels.lr_check(t(dl), t(dr), 1.0, max_shift=16).numpy()
    same(got, pk.lr_check_pallas(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                                 max_shift=16, block_rows=16),
         np.stack([oracle.lr_check(a, b, 1.0) for a, b in zip(dl, dr)]))


def test_lr_check_nonfinite_matches_pallas(no_launch):
    rng = np.random.default_rng(29)
    dl = rng.uniform(0, 15, (16, 40)).astype(np.float32)
    dr = rng.uniform(0, 15, (16, 40)).astype(np.float32)
    for a in (dl, dr):
        a[rng.random(a.shape) < 0.15] = np.inf
        a[rng.random(a.shape) < 0.1] = -np.inf
        a[rng.random(a.shape) < 0.1] = np.nan
    dl[3, 30:] = dr[3, :] = 25.0                    # beyond the select's band
    got = kernels.lr_check(t(dl[None]), t(dr[None]), 1.0, max_shift=16).numpy()
    same(got[0], pk.lr_check_pallas(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                                    max_shift=16, block_rows=16))


@pytest.mark.parametrize("min_area", [9, 50])
def test_remove_speckles_matches_pallas_and_oracle(min_area, no_launch):
    rng = np.random.default_rng(10)
    d = rng.integers(0, 8, (2, 47, 61)).astype(np.float32)
    d[rng.random(d.shape) < 0.35] = np.inf
    got = kernels.remove_speckles(t(d), 1.0, min_area).numpy()
    same(got, pk.remove_speckles_pallas(jnp.asarray(d), 1.0, min_area),
         np.stack([oracle.remove_speckles(x, 1.0, min_area) for x in d]))


def test_wrappers_reject_mixed_or_unsupported_devices():
    cpu = torch.zeros((1, 4, 4))
    meta = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        kernels.lr_check(cpu, meta, 1.0, 4)
    with pytest.raises(ValueError):
        kernels.remove_speckles(meta, 1.0, 4)


def test_c_signatures_match_the_sources():
    """Every ``extern "C"`` entry of csrc/ has ctypes argtypes of the right
    arity and kinds: pointers (and the stream) c_void_p, int c_int, float
    c_float."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = tuple(
                ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in (" ".join(q.split()) for q in params.split(",")))
    assert found == _build.SIGNATURES


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_path_is_keyed_by_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.name == _build.LIB_NAME and path.parent.parent == _build.BUILD_DIR
    assert _build.library_path() == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != path
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("ablation", sorted(kernel_ab.ABLATIONS))
def test_kernel_ab_ablations_still_apply_to_the_census_source(ablation):
    """Each of kernel_ab's K1 ablations changes csrc/census_cost.cu, each
    of its edits matching exactly one place."""
    text = (_build.CSRC / "census_cost.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.ABLATIONS[ablation])
    assert out is not None and out != text
    assert kernel_ab.patched("x x", [("x", "y")]) is None     # twice
    assert kernel_ab.patched("x", [("z", "y")]) is None       # nowhere


@pytest.mark.parametrize("ablation", sorted(kernel_ab.WTA_ABLATIONS))
def test_kernel_ab_wta_ablations_still_apply_to_the_wta_source(ablation):
    text = (_build.CSRC / "wta.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.WTA_ABLATIONS[ablation])
    assert out is not None and out != text


@pytest.mark.parametrize("ablation", sorted(kernel_ab.S1_ABLATIONS))
def test_kernel_ab_s1_ablations_still_apply_to_the_probe_source(ablation):
    """Each S1 ablation stops at the rounds the caller gives and takes out
    its passes at their call sites, each edit matching exactly one place."""
    text = (_build.CSRC / "probe_speckle.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.S1_ABLATIONS[ablation])
    assert out is not None and out != text
    assert "if (it >= __ldcg(rounds + program)) break;" in out
    assert all(text.count(call) == 1 for call in kernel_ab._S1_PASS_CALLS)


@pytest.mark.parametrize("ablation", sorted(kernel_ab.S4_ABLATIONS))
def test_kernel_ab_s4_ablations_still_apply_to_the_probe_source(ablation):
    """Each S4 ablation takes a round's steps out at their call sites in
    ``tail_kernel``, each call site matching exactly one place, or (the
    warp merge) replaces the inserts of a thread's runs; every block still
    reaches every barrier it leaves in."""
    text = (_build.CSRC / "probe_speckle.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.S4_ABLATIONS[ablation])
    assert out is not None and out != text
    assert all(text.count(step) == 1 for step in kernel_ab._S4_STEPS)
    kept = [step for step in kernel_ab._S4_STEPS if step in out]
    if ablation == "warp merge":
        assert kept == list(kernel_ab._S4_STEPS)
        assert out.count("__match_any_sync(kFull, k)") == \
            text.count("__match_any_sync(kFull, k)") + 1
    elif ablation == "barriers only":
        assert len(kept) == 2 and all("grid.sync()" in s for s in kept)
    else:
        assert len(kept) == 2 and not any("grid.sync()" in s for s in kept)


@pytest.mark.parametrize("ablation", sorted(kernel_ab.CHAIN_ABLATIONS))
def test_kernel_ab_chain_ablations_still_apply_to_the_probe_source(ablation):
    text = (_build.CSRC / "probe_recurrence.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.CHAIN_ABLATIONS[ablation])
    assert out is not None and out != text


def test_kernel_ab_groups_and_the_probe_entries():
    """``--only`` picks among the groups, each comparing one C entry; the
    probe kernels' entries are found in their sources."""
    assert set(kernel_ab.GROUPS) == {"k4", "k1", "wta", "scan16", "s1",
                                     "chain", "s2", "s4"}
    found = kernel_ab.sources_defining(
        _build.CSRC, [kernel_ab.GROUP_ENTRIES[g]
                      for g in ("scan16", "s1", "chain", "s2", "s4")])
    assert sorted(found) == ["probe_int16.cu", "probe_recurrence.cu",
                             "probe_speckle.cu"]
    with pytest.raises(SystemExit, match="--only"):
        kernel_ab.main(["--parent", ".", "--only", "k2"])


def test_kernel_ab_calls_the_first_chain_entries_without_lanes():
    """The parent's P1/P2 entries took no lane count (a warp per path):
    kernel_ab gives them this checkout's arguments up to ``p1``, then the
    stream."""
    first = kernel_ab.CHAIN_WARP_PER_PATH
    assert first["sgm_probe_chain"] == \
        _build.SIGNATURES["sgm_probe_chain"][:-2] + (ctypes.c_void_p,)
    assert first["sgm_probe_chainio"] == \
        _build.SIGNATURES["sgm_probe_chainio"][:-2] + (ctypes.c_void_p,)
    # how kernel_ab tells the two apart: this checkout's entries take lanes
    assert "int lanes" in (_build.CSRC / "probe_recurrence.cu").read_text()


def test_isa_probe_program_and_its_listing():
    """isa_probe's program has one kernel per operation, each a chain of
    dependent applications timed by the SM clock, and its SASS counts skip
    NOP, BRA and EXIT."""
    from soc_project_stereo_matching_tpu_torch import isa_probe

    text = isa_probe.source()
    for i, expr in enumerate(isa_probe.OPS.values()):
        assert f"void op{i}(" in text and f"x = {expr};" in text
    assert text.count("clock64()") == 2 * len(isa_probe.OPS)
    listing = ("\n\tFunction : op0\n\t\t/*0000*/ MOV R1 ;\n\t\t/*0010*/ NOP ;"
               "\n\t\t/*0020*/ EXIT ;\n\tFunction : op1\n\t\t/*0000*/ IADD3 R1 ;"
               "\n\t\t/*0010*/ VIMNMX R2 ;\n\t\t/*0020*/ BRA 0x10 ;")
    assert isa_probe.sass_counts(listing) == {"op0": 1, "op1": 2}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            isa_probe.main(["--out", "/nonexistent/never-written.json"])


def test_kernel_ab_finds_the_sources_of_its_entries(tmp_path):
    """Each compared C entry is found in the source that defines it, in
    this checkout (the WTA in wta.cu) and in one where the WTA still lives
    beside the scans; a checkout without it is refused."""
    found = kernel_ab.sources_defining(_build.CSRC, kernel_ab.ENTRIES)
    assert sorted(found) == ["census_cost.cu", "speckle.cu", "wta.cu"]
    (tmp_path / "aggregate.cu").write_text(
        'extern "C" int sgm_wta_reduce(const void* a) { return 0; }')
    (tmp_path / "speckle.cu").write_text(
        'extern "C" int sgm_remove_speckles(const void* a) { return 0; }\n'
        'extern "C" int sgm_census_cost(const void* a) { return 0; }')
    assert sorted(kernel_ab.sources_defining(tmp_path, kernel_ab.ENTRIES)) == \
        ["aggregate.cu", "speckle.cu"]
    (tmp_path / "aggregate.cu").unlink()
    with pytest.raises(SystemExit, match="sgm_wta_reduce"):
        kernel_ab.sources_defining(tmp_path, kernel_ab.ENTRIES)


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::tile_kernel(float const*, int*, int)",
     "tile_kernel"),
    ("(anonymous namespace)::union_kernel(float const*, int*, int, int)",
     "union_kernel"),
    ("void at::native::fill_kernel<4, unsigned char>(int, char*)",
     "fill_kernel")])
def test_kernel_ab_names_profiler_kernels(key, name):
    assert kernel_ab.kernel_name(key) == name


def test_kernel_ab_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(SystemExit):
        kernel_ab.main(["--parent", str(tmp_path), "--out",
                        str(tmp_path / "ab.json")])
    assert not (tmp_path / "ab.json").exists()
