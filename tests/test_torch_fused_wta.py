"""The fused aggregation + WTA forms of the K2 scans on the CPU, bit for bit.

The CUDA group kernel's two new modes (``csrc/aggregate.cu``: the WTA
epilogue of the last launch, and the two-order launch) run only on a card,
where ``test_torch_cuda.py`` and ``chip_smoke.py`` hold them against their
plain versions.  Here the plain versions, which transcribe the kernel's
order of work, are held against the Pallas entries they replace, run as
the JAX package's own tests run them on the CPU (interpret mode):

* ``directional_scan_group_bidir_plain`` against
  ``_directional_scan_group_bidir``: volume and planes-only forms, with and
  without an accumulator, wrap and restart, the 8- and 4-path roll sets,
  D = 1 and 16, dmin 0 and > 0, the inverse view or not;
* ``directional_scan_group(..., wta=...)`` against
  ``_directional_scan_group(..., wta=...)``'s planes;
* the port's CPU ``aggregate_paths_wta`` and ``aggregate_paths`` against the
  JAX entries with ``bidir`` True and False;
* the epilogue's decomposition (strips of columns, chunks of planes, the
  inverse view across strip edges) against ``wta_reduce_plain``;
* the tiled matcher's local mode, whose vertical pair is one two-order
  launch, against the JAX tiled matcher;
* the split of a group over launches (the epilogue on the last), and
  ``kernel_ab.py``'s ablations of the fused launch and its call of the
  other checkout's group entry.

Shapes are the JAX tests' (H=37, W=53, D=16, ``block_rows=8``): the Pallas
entries take a scan axis of whole chunks, so their inputs are padded with
zero rows, which a scan passes through unchanged, and their outputs cropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_project_stereo_matching_tpu import SGMOptions
from soc_project_stereo_matching_tpu.ops import pallas_kernels as pk
from soc_project_stereo_matching_tpu.parallel import mesh as j_mesh
from soc_project_stereo_matching_tpu.parallel import tiles as j_tiles
from soc_project_stereo_matching_tpu_torch import _build, kernel_ab
from soc_project_stereo_matching_tpu_torch.config import from_jax
from soc_project_stereo_matching_tpu_torch.ops import kernels
from soc_project_stereo_matching_tpu_torch.parallel.mesh import make_mesh
from soc_project_stereo_matching_tpu_torch.parallel.tiles import make_tiled_matcher

P1, P2_INIT = 10, 150
B, H, W = 2, 37, 53
ROWS = 8                                  # the Pallas entries' block_rows
ROLLS = {8: ((0, 1, -1), (0, -1, 1)), 4: ((0,), (0,))}
# (dmin, include_inverse) of the WTA forms
WTA_FORMS = {"fwd": (0, False), "both": (0, True), "dmin_fwd": (5, False),
             "dmin_both": (5, True)}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def same_planes(got, want):
    """(fwd, inv or None) WTAPlanes against a list of 5 or 10 planes."""
    fwd, inv = got
    flat = list(fwd) + ([] if inv is None else list(inv))
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert g.dtype == torch.int32
        same(g, w)


def inputs(seed, d, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (B, h, d, w), dtype=np.uint8),
            rng.integers(0, 256, (B, h, w), dtype=np.uint8),
            rng.integers(0, 900, (B, h, d, w)).astype(np.uint16))


def padded(x, rows):
    """``x`` with zero rows after its scan axis (1) up to ``rows``."""
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, rows - x.shape[1])
    return jnp.pad(jnp.asarray(x), pad)


def hp(h=H):
    return -(-h // ROWS) * ROWS


@pytest.fixture
def no_launch():
    before = dict(kernels.LAUNCHES)
    yield
    assert kernels.LAUNCHES == before


def pallas_bidir(cost, img, acc, rolls_f, rolls_b, restart, wta):
    h = cost.shape[1]
    img32 = jnp.asarray(img.astype(np.int32))
    p2 = pk._stack_p2_fb(
        padded(pk._p2_planes(img32, rolls_f, +1, P1, P2_INIT), hp(h)),
        padded(pk._p2_planes(img32, rolls_b, -1, P1, P2_INIT), hp(h)))
    res = pk._directional_scan_group_bidir(
        padded(cost.astype(np.int8), hp(h)), p2,
        None if acc is None else padded(acc, hp(h)), rolls_f, rolls_b, P1,
        restart, ROWS, wta=wta)
    if wta is None:
        return res[:, :h]
    return [p[:, :h] for p in res]


# --- the two-order scan --------------------------------------------------------

def check_bidir(paths, restart, d, with_acc, form, h=H):
    """The two-order scan's plain version (two launches meeting at the
    middle row) against the Pallas entry, at ``h`` rows."""
    cost, img, acc = inputs(70 + d, d, h)
    rolls_f, rolls_b = ROLLS[paths]
    wta = WTA_FORMS.get(form)
    start = t(acc.copy()) if with_acc else None
    got = kernels.directional_scan_group_bidir(
        t(cost), t(img), start, rolls_f, rolls_b, P1, P2_INIT, restart, wta)
    want = pallas_bidir(cost, img, acc if with_acc else None, rolls_f,
                        rolls_b, restart, wta)
    if wta is None:
        assert got.dtype == torch.uint16
        same(got, want)
        if with_acc:                 # the sums land on the accumulator
            assert got.data_ptr() == start.data_ptr()
    else:
        same_planes(got, want)
        if with_acc:                 # left holding the first launch's sums:
            m = kernels.meeting_row(h)   # each order's over its first half
            parked = acc.copy()
            for rows, rolls, reverse in ((slice(0, m), rolls_f, False),
                                         (slice(m, h), rolls_b, True)):
                if rows.stop > rows.start:
                    parked[:, rows] = kernels.directional_scan_group_plain(
                        t(cost[:, rows]), t(img[:, rows]),
                        t(acc[:, rows].copy()), rolls, reverse, P1, P2_INIT,
                        restart).numpy()
            same(start, parked)


@pytest.mark.parametrize("with_acc,form", [(False, "volume"), (True, "volume"),
                                           (False, "fwd"), (True, "dmin_both")])
@pytest.mark.parametrize("d", [1, 16])
@pytest.mark.parametrize("paths,restart", [(8, False), (8, True), (4, False)])
def test_bidir_plain_matches_pallas(paths, restart, d, with_acc, form,
                                    no_launch):
    check_bidir(paths, restart, d, with_acc, form)


@pytest.mark.parametrize("h,paths,restart,d,with_acc,form", [
    (1, 8, False, 16, True, "dmin_both"), (1, 8, True, 1, False, "volume"),
    (2, 8, True, 16, True, "volume"), (2, 4, False, 16, False, "fwd"),
    (40, 8, False, 16, True, "dmin_both"), (40, 8, True, 16, True, "volume"),
    (5, 8, True, 16, False, "both")])
def test_bidir_plain_meets_at_the_middle_row_of_any_scan(h, paths, restart, d,
                                                         with_acc, form,
                                                         no_launch):
    """S = 1 (the forward order's first half is empty: it starts fresh in
    the second launch), S = 2 (one row a half), an odd S (the reverse
    order's half the longer) and an even S."""
    check_bidir(paths, restart, d, with_acc, form, h)


@pytest.mark.parametrize("with_acc,form", [(False, "both"), (True, "dmin_fwd")])
@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("rolls,reverse", [((0, 1, -1), False),
                                           ((0, -1, 1), True),
                                           ((0,), True)])
def test_group_wta_plain_matches_pallas(rolls, reverse, restart, with_acc,
                                        form, no_launch):
    """The one-order group launch with the epilogue: its planes only."""
    cost, img, acc = inputs(71, 16)
    wta = WTA_FORMS[form]
    p2 = pk._p2_planes(jnp.asarray(img.astype(np.int32)), rolls,
                       -1 if reverse else 1, P1, P2_INIT)
    _, want = pk._directional_scan_group(
        padded(cost.astype(np.int8), hp()), padded(p2, hp()),
        padded(acc, hp()) if with_acc else None, rolls, reverse, P1, restart,
        ROWS, wta=wta)
    start = t(acc.copy()) if with_acc else None
    got = kernels.directional_scan_group(t(cost), t(img), start, rolls,
                                         reverse, P1, P2_INIT, restart,
                                         wta=wta)
    same_planes(got, [p[:, :H] for p in want])
    if with_acc:
        same(start, acc)             # no volume is stored


def test_group_wta_takes_no_carries():
    cost, img, _ = inputs(72, 4)
    with pytest.raises(ValueError, match="no carries"):
        kernels.directional_scan_group(t(cost), t(img), None, (0,), False, P1,
                                       P2_INIT, False, want_carry=True,
                                       wta=(0, True))


# --- the main path's wrappers ---------------------------------------------------

@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("paths,mode,dmin,dmax,inverse", [
    (8, "wrap", 0, 16, True), (8, "restart", 6, 22, False),
    (4, "restart", 3, 4, True)])
def test_aggregate_paths_wta_matches_pallas_both_forms(paths, mode, dmin, dmax,
                                                       inverse, bidir,
                                                       no_launch):
    """The port's one route against both of the JAX package's: the
    two-order launch (``bidir=True``) and the two group launches, the last
    with the WTA epilogue (``bidir=False``)."""
    check_aggregate_wta(paths, mode, dmin, dmax, inverse, bidir)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("h", [1, 2])
def test_aggregate_paths_wta_matches_pallas_at_one_and_two_rows(h, bidir,
                                                                no_launch):
    """The meeting row at S = 1 (the forward order's first half empty) and
    S = 2, through the main path's wrappers, against both JAX forms."""
    check_aggregate_wta(8, "restart", 6, 22, True, bidir, h)


def check_aggregate_wta(paths, mode, dmin, dmax, inverse, bidir, h=H):
    d = dmax - dmin
    cost, img, _ = inputs(73, d, h)
    opt = SGMOptions(num_paths=paths, min_disparity=dmin, max_disparity=dmax)
    jc, ji = jnp.asarray(cost), jnp.asarray(img)
    got = kernels.aggregate_paths_wta(t(cost), t(img), from_jax(opt), mode,
                                      include_inverse=inverse)
    want_f, want_i = pk.aggregate_paths_wta(
        jc, ji, opt, mode, block_rows=ROWS, include_inverse=inverse,
        bidir=bidir)
    same_planes(got, list(want_f) + ([] if want_i is None else list(want_i)))
    same(kernels.aggregate_paths(t(cost), t(img), from_jax(opt), mode),
         pk.aggregate_paths(jc, ji, opt, mode, block_rows=ROWS, bidir=bidir))


# --- the epilogue's decomposition -------------------------------------------------

@pytest.mark.parametrize("strip", [2, 6, 10, 17, None])
@pytest.mark.parametrize("d,dmin,chunk", [(1, 0, 1), (1, 30, 4), (16, 0, 4),
                                          (16, 24, 3), (16, 5, 16),
                                          (40, 24, 8), (40, 13, 12)])
def test_epilogue_decomposition_matches_wta_reduce(d, dmin, chunk, strip):
    """Strips narrower than the inverse view's reach (dmin + D - 1 columns)
    cut it in several places; chunks that do not divide D leave a short
    last chunk; ties and real 65535 costs beside the inverse view's fill."""
    rng = np.random.default_rng(74 + d + dmin)
    total = rng.integers(0, 12, (B, 5, d, W)).astype(np.int32)   # many ties
    total[0, 0, :, 3] = 65535
    total[1, 1, ::2, 40:] = 65535
    opt = from_jax(SGMOptions(min_disparity=dmin, max_disparity=dmin + d))
    for inverse in (True, False):
        got = kernels.wta_epilogue_plain(t(total), dmin, inverse, strip, chunk)
        want = kernels.wta_reduce_plain(t(total).to(torch.uint16), opt,
                                        inverse)
        same_planes(got, list(want[0]) + ([] if want[1] is None else
                                          list(want[1])))


# --- the tiled matcher's local mode ------------------------------------------------

def test_tiled_local_mode_matches_jax(no_launch):
    """On a 1-rank mesh the tiled kernel path's vertical pair is one
    two-order launch (its plain version here), as the JAX matcher's bidir
    scan; the outputs agree bit for bit."""
    rng = np.random.default_rng(75)
    h, w = 16, 64
    left = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    right = np.roll(left, -3, axis=-1)
    opt = SGMOptions(max_disparity=16, min_speckle_area=8)
    mesh = j_mesh.make_mesh(1, 1)
    want = j_tiles.make_tiled_matcher(opt, mesh, h, w, cross_tile="local",
                                      use_pallas=True)(jnp.asarray(left),
                                                       jnp.asarray(right))
    got = make_tiled_matcher(from_jax(opt), make_mesh(1, 1), h, w, "local")(
        t(left), t(right))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the launches around the kernel --------------------------------------------------

@pytest.mark.parametrize("n,plain,with_wta,want", [
    (3, 3, 3, [(0, 3)]), (3, 2, 2, [(0, 1), (1, 3)]),
    (3, 3, 2, [(0, 1), (1, 3)]), (3, 2, 1, [(0, 2), (2, 3)]),
    (3, 1, 1, [(0, 1), (1, 2), (2, 3)]), (1, 3, 1, [(0, 1)]),
    (2, 1, 1, [(0, 1), (1, 2)]), (3, 2, 3, [(0, 1), (1, 3)])])
def test_launch_parts_split_a_group_with_its_epilogue_last(monkeypatch, n,
                                                           plain, with_wta,
                                                           want):
    """A group the card cannot hold in one launch: the leading launches take
    what a launch without the epilogue takes, the last what launches with
    it and without it both take; without the epilogue the split is the
    capacity's from the front."""
    monkeypatch.setattr(kernels, "group_capacity",
                        lambda cost, out, wta=False, ranges=0: with_wta if wta else plain)
    parts = kernels._launch_parts(None, None, n, True)
    assert parts == want
    assert [k1 - k0 for k0, k1 in parts][-1] <= min(with_wta, plain)
    plain_parts = kernels._launch_parts(None, None, n, False)
    assert plain_parts == [(k0, min(k0 + plain, n)) for k0 in range(0, n, plain)]


def test_bidir_takes_two_orders_of_one_group(no_launch):
    cost, img, _ = inputs(76, 4)
    with pytest.raises(ValueError, match="differ in directions"):
        kernels.directional_scan_group_bidir(t(cost), t(img), None, (0, 1, -1),
                                             (0,), P1, P2_INIT, False)


@pytest.mark.parametrize("ablation", sorted(kernel_ab.FUSED_ABLATIONS))
def test_kernel_ab_fused_ablations_still_apply_to_the_scan_source(ablation):
    """Each of kernel_ab's ablations of the fused launch changes
    csrc/aggregate.cu, each edit matching exactly one place."""
    text = (_build.CSRC / "aggregate.cu").read_text()
    out = kernel_ab.patched(text, kernel_ab.FUSED_ABLATIONS[ablation])
    assert out is not None and out != text


def test_kernel_ab_calls_the_parent_group_entry_with_its_signature():
    """The other checkout's group entry before the two-order launch took 8
    pointers, 14 ints and the stream; its first fused form added the ring,
    the planes and 8 ints (the second roll set and its flag, the views,
    dmin); the next took the ScanPass array instead of the carries and
    rolls: 6 pointers, 14 ints and the stream; the next added the work
    buffer of several clusters an image; this one adds the plan argument
    ``ranges`` (an int before the stream), to its plan and capacity
    entries too.  ``group_form`` tells the five apart by their sources."""
    old = kernel_ab.GROUP_BEFORE_FUSED["sgm_scan_group"]
    first = kernel_ab.GROUP_TWO_ORDER["sgm_scan_group"]
    passes = kernel_ab.GROUP_PASSES["sgm_scan_group"]
    work = kernel_ab.GROUP_WORK["sgm_scan_group"]
    new = _build.SIGNATURES["sgm_scan_group"]
    assert (len(old), len(first), len(passes), len(work), len(new)) == \
        (23, 31, 21, 22, 23)
    assert old[:8] + old[22:] == first[:8] + first[30:]
    assert new[-1] == first[-1] and work[:6] + work[7:] == passes
    assert new[:-2] + new[-1:] == work
    for entry in ("sgm_scan_group_capacity", "sgm_scan_group_plan"):
        sig = _build.SIGNATURES[entry]
        assert sig[:-2] + sig[-1:] == kernel_ab.GROUP_WORK[entry]
    assert kernel_ab.group_form(["struct ScanPass",
                                 "void* planes, void* work"]) == "work"
    assert kernel_ab.GROUP_BEFORE_FUSED["sgm_scan_group_capacity"] == \
        kernel_ab.GROUP_WORK["sgm_scan_group_capacity"][:5] + \
        kernel_ab.GROUP_WORK["sgm_scan_group_capacity"][6:]
    text = (_build.CSRC / "aggregate.cu").read_text()
    assert kernel_ab.group_form([text]) == "ranges"
    assert kernel_ab.group_form(["struct ScanPass"]) == "passes"
    assert kernel_ab.group_form(["int two_order, int q0"]) == "two_order"
    assert kernel_ab.group_form(["int accumulate, void* stream"]) == "before"


def test_scan_pass_matches_the_kernels_struct():
    """``kernels.ScanPass`` has the fields of csrc/aggregate.cu's
    ``ScanPass`` in its order, at the offsets the C ABI gives them."""
    text = (_build.CSRC / "aggregate.cu").read_text()
    body = text[text.index("struct ScanPass {"):]
    body = body[:body.index("};")]
    c_fields = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            c_fields += [name.strip().split("[")[0].lstrip("*")
                         for name in decl.split(" ", 1)[1].split(",")]
    c_fields = [f.split()[-1].lstrip("*") for f in c_fields]
    names = [name for name, _ in kernels.ScanPass._fields_]
    assert c_fields == names
    offsets = [getattr(kernels.ScanPass, name).offset for name in names]
    assert offsets == [0, 8, 16, 24, 32, 40, 52, 56, 60, 64]


@pytest.mark.parametrize("s,cap,cap_wta", [(1, 3, 3), (2, 3, 3), (7, 3, 3),
                                           (8, 2, 2), (8, 3, 1)])
def test_two_order_scans_launch_twice_meeting_at_the_middle_row(
        monkeypatch, s, cap, cap_wta, no_launch):
    """The card route of ``aggregate_paths_wta`` and of
    ``aggregate_paths`` (the horizontal pair by the path scan's one launch
    between the transposes), run on CPU
    tensors with the C entries recorded instead of called: each two-order
    scan is two launches a part of its group, each with the two orders on
    sets of clusters of their own; the first over [0, m) forward and
    [m, S) in reverse with carries out where the other half is not empty,
    the second over the other halves from those carries; the epilogue on
    the last part's second launch."""
    launches = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "group_directions",
                        lambda cost, out, wta=False, ranges=0: cap_wta if wta else cap)
    monkeypatch.setattr(kernels, "_launch",
                        lambda entry, counter, *args: launches.append(counter))

    def group(counter, cost, img, out, passes, npass, n, carry_n, restart, p1,
              p2_init, accumulate, views=0, dmin=0, finished=None,
              planes=None, ranges=0):
        assert ranges == 0      # the main path leaves the plan to the entry
        launches.append((counter, cost.shape[1], npass, n, accumulate, views,
                         [(p.lo, p.hi, p.reverse, bool(p.cin_cost),
                           bool(p.cout_cost), bool(p.prev_gray))
                          for p in passes]))

    monkeypatch.setattr(kernels, "_launch_group", group)
    b, w, d = 2, 6, 4
    cost = torch.zeros((b, s, d, w), dtype=torch.uint8)
    img = torch.zeros((b, s, w), dtype=torch.uint8)
    opt = from_jax(SGMOptions(max_disparity=d))

    def scan(counter, length, acc, epilogue, parts):
        m = length // 2
        out = []
        for k0, k1 in parts:
            first = [(0, m, 0, False, m > 0, False),
                     (m, length, 1, False, m > 0, False)]
            second = [(m, length, 0, m > 0, False, m > 0),
                      (0, m, 1, m > 0, False, True)]
            out += [(counter, length, 1, k1 - k0, acc or k0 > 0, 0, first),
                    (counter, length, 1, k1 - k0, True,
                     2 if epilogue and k1 == 3 else 0, second)]
        return out

    # the horizontal pair: the path scan, one launch (csrc/path_scan.cu)
    pair = ["volume_transpose"] * 2 + ["horizontal_paths"] + \
        ["volume_transpose"]
    parts = kernels._launch_parts(None, None, 3, True)
    kernels.aggregate_paths_wta(cost, img, opt)
    assert launches == pair + scan("aggregate_paths_wta", s, True, True, parts)
    launches.clear()
    kernels.aggregate_paths(cost, img, opt)
    assert launches == pair + scan("aggregate_paths", s, True, False,
                                   kernels._launch_parts(None, None, 3, False))
