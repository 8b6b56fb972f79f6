"""The port's CUDA kernels against their plain PyTorch versions, and the
dispatch and build rules around them.

This file imports no JAX, so on a machine with a card it runs without
the JAX package (``--noconftest`` skips tests/conftest.py, which does):

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests marked ``gpu`` skip without a CUDA device.  Tolerances on the card:
kernels A to D bit-exact, kernel E exact: each keeps its plain version's
arithmetic order op by op (built with --fmad=false), and E and its plain
version both call the card's expf.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from hcmvs_tpu_torch import kernels
from hcmvs_tpu_torch.core.camera import Camera
from hcmvs_tpu_torch.dense.types import make_view_geometry
from hcmvs_tpu_torch.ops import rect_gather as rg
from hcmvs_tpu_torch.ops import volume as vol
from hcmvs_tpu_torch.ops import zncc_warped as zw
from hcmvs_tpu_torch.utils.synth import make_plane_scene

# pytest-xdist runs one process per core; torch's own intra-op pool in
# each of them would oversubscribe the cores many times over.
torch.set_num_threads(1)
H, W, V = 96, 200, 3     # W unaligned: exercises the tile padding


def _u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint16).view(np.int16)).view(
        torch.uint16)


def _scene(device):
    sc = make_plane_scene(np.random.default_rng(4), h=H, w=W,
                          n_views=V + 1)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(device)
    geom = make_view_geometry(cams[0], cams[1:])
    src = torch.from_numpy(np.stack(sc.images[1:])).to(device)
    return sc, geom, src


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dispatch_takes_plain_versions_only_on_cpu():
    cpu = torch.zeros(2)
    assert not kernels.use_kernel(cpu)
    with kernels.plain_versions():
        assert not kernels.use_kernel(cpu)
    with pytest.raises(ValueError):
        kernels.use_kernel(torch.zeros(2, device="meta"))
    # the launchers never fall back: CPU tensors are refused
    tab = _u16(np.zeros((4, 128)))
    with pytest.raises(ValueError):
        kernels.volume_lookup(tab, torch.zeros(4, 9))
    with pytest.raises(ValueError):
        kernels.rect_lookup(torch.zeros(1, 2, 40, 512),
                            torch.zeros(1, 8, 128, dtype=torch.int32),
                            torch.zeros(1, 8, 128), torch.zeros(1, 8, 128),
                            torch.zeros(1, 1, 1, dtype=torch.int32),
                            torch.zeros(8, 128))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such target"):
        kernels.build()


def test_earlier_designs_build_apart(tmp_path, monkeypatch):
    """The earlier designs of kernels B and D build into a library of
    their own, from csrc/earlier/*.cu alone (with the shared headers),
    and each build is found again by its hash."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    lib = kernels.build()
    earlier = kernels.build(kernels.EARLIER)
    assert lib.exists() and earlier.exists()
    assert lib.parent != earlier.parent
    units = [Path(line.split()[-1]) for line in log.read_text().splitlines()
             if " -c " in line]
    assert sorted(u.name for u in units if u.parent == kernels.EARLIER) == [
        "volume_lookup.cu", "volume_lookup_multi.cu"]
    assert sorted(u for u in units if u.parent == kernels.CSRC) == sorted(
        kernels.CSRC.glob("*.cu"))
    n_lines = len(log.read_text().splitlines())
    assert kernels.build(kernels.EARLIER) == earlier
    assert len(log.read_text().splitlines()) == n_lines


def test_plain_rect_build_chunking_is_invariant(monkeypatch):
    """The plain version of kernel A works through tiles in chunks; the
    chunk size must not change a single entry."""
    _, geom, src = _scene("cpu")
    s = vol.rect_build_setup(geom, src, torch.tensor(3.0),
                             torch.tensor(6.0))
    args = (s.rect_src, s.rb, s.cb, s.rowf_g, s.c0w_g, s.kp_g, s.p_pad)
    a = vol._rect_build_plain(*args)
    monkeypatch.setattr(vol, "_PLAIN_BUILD_TILES", 3)
    b = vol._rect_build_plain(*args)
    assert torch.equal(a.to(torch.int32), b.to(torch.int32))


def test_init_scene_state_keeps_seed_depths():
    from hcmvs_tpu_torch.dense.scene_driver import (SceneTensors,
                                                    init_scene_state)
    sc = make_plane_scene(np.random.default_rng(0), h=24, w=32, n_views=3)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC"))
    seed = torch.zeros(3, 24, 32)
    seed[:, 5:9, 10:20] = 4.25
    scene = SceneTensors(
        gray=torch.stack([torch.from_numpy(im) for im in sc.images]),
        cams=cams, nbr_idx=torch.tensor([[1, 2], [0, 2], [0, 1]]),
        nbr_valid=torch.ones(3, 2, dtype=torch.bool),
        d_min=torch.full((3,), sc.d_min), d_max=torch.full((3,), sc.d_max),
        seed_depth=seed)
    st = init_scene_state(torch.Generator().manual_seed(0), scene)
    assert torch.equal(st.depth[seed > 0], seed[seed > 0])
    free = st.depth[seed == 0]
    assert free.min() >= sc.d_min and free.max() <= sc.d_max
    assert torch.equal(st.cost, torch.full((3, 24, 32), 2.0))


@pytest.mark.gpu
def test_kernel_a_matches_plain():
    dev = _cuda()
    sc, geom, src = _scene(dev)
    d_min = torch.tensor(sc.d_min, device=dev)
    d_max = torch.tensor(sc.d_max, device=dev)
    before = kernels.launches["rect_build"]
    out = vol.build_volume_tables_rect(geom, src, d_min, d_max)
    assert kernels.launches["rect_build"] == before + 1
    with kernels.plain_versions():
        ref = vol.build_volume_tables_rect(geom, src, d_min, d_max)
    assert kernels.launches["rect_build"] == before + 1
    assert torch.equal(out.tab.to(torch.int32), ref.tab.to(torch.int32))
    torch.testing.assert_close(out.sig_lo, ref.sig_lo)


@pytest.mark.gpu
def test_kernel_a_edges_match_plain():
    """Kernel A on fields that reach every branch of its warp-per-pixel
    geometry: table padding rows, rows outside the band, columns clipped
    at 0 and 1022, windows that reach the frame's last column."""
    dev = _cuda()
    rng = np.random.default_rng(21)
    v, h_r, w_r, n_tiles = 2, 96, 1536, 5
    p_used = n_tiles * 1024
    p_pad = p_used + 1000                    # not a multiple of a block
    f32 = np.float32
    rowf = rng.uniform(-3.0, 91.0, (v, p_used))
    rowf[:, ::97] = -1e9                     # the invalid-row sentinel
    c0w = rng.uniform(-60.0, 1100.0, (v, p_used))
    kp = rng.uniform(-2.0, 9.0, (v, p_used))
    rb = rng.integers(0, h_r // 8 - 11 + 1, (v, n_tiles))
    cb = rng.integers(0, w_r // 512, (v, n_tiles))   # last window overhangs
    args = [torch.from_numpy(rng.random((v, h_r, w_r)).astype(f32)),
            torch.from_numpy(rb.astype(np.int32)),
            torch.from_numpy(cb.astype(np.int32))] + [
        torch.from_numpy(x.astype(f32)) for x in (rowf, c0w, kp)]
    args = [a.to(dev) for a in args] + [p_pad]
    before = kernels.launches["rect_build"]
    out = vol.rect_build_tab(*args)
    assert kernels.launches["rect_build"] == before + 1
    with kernels.plain_versions():
        ref = vol.rect_build_tab(*args)
    assert torch.equal(out.to(torch.int32), ref.to(torch.int32))
    assert not out[:, p_used:].to(torch.int32).any()
    # every branch was taken: in and out of the band, clipped columns,
    # windows inside the frame and overhanging it
    r0 = np.floor(rowf)
    assert ((r0 >= 0) & (r0 + 1 < 88)).mean() > 0.5
    assert ((r0 < 0) | (r0 + 1 >= 88)).any()
    base = c0w[..., None] + kp[..., None] * np.arange(128)
    assert (base < 0).any() and (base > 1022).any()
    assert (cb * 512 + 1023 >= w_r).any() and (cb * 512 + 1023 < w_r).any()


def _field(rng, shape, lo, hi, device="cpu", offset=0):
    """A float32 field on ``lo..hi`` with every seventh entry an exact
    integer (the taps' edges: floor f == f), starting ``offset`` floats
    past its allocation on ``device`` (offset 1 is not 16 B aligned)."""
    n = int(np.prod(shape))
    f = rng.uniform(lo, hi, n + offset).astype(np.float32)
    f[::7] = rng.integers(int(lo), int(hi) + 1, f[::7].shape)
    return torch.from_numpy(f).to(device)[offset:].view(*shape)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("s", [9, 16, 36, 64, 5])
def test_kernel_b_matches_plain(s, offset, monkeypatch):
    """Kernel B at the paths' widths and a generic one (5), on a row count
    that is a multiple of no tile, with fields below 0, above 126 and at
    exact integers; ``offset`` 1 takes the unaligned, scalar walk."""
    dev = _cuda()
    rng = np.random.default_rng(2)
    p = 4099
    tab = _u16(rng.integers(0, 65536, (p, 128))).to(dev)
    f = _field(rng, (p, s), -3, 130, dev, offset)
    assert (f.data_ptr() % 16 != 0) == bool(offset)
    before = kernels.launches["volume_lookup"]
    out = vol.volume_lookup(tab, f)
    assert kernels.launches["volume_lookup"] == before + 1
    with kernels.plain_versions():
        ref = vol.volume_lookup(tab, f)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        kernels.volume_lookup(tab, f[:, ::2])          # not contiguous
    for d in (192, 640):        # depths the per-plane build never makes
        with pytest.raises(ValueError):
            kernels.volume_lookup(_u16(np.zeros((8, d))).to(dev),
                                  torch.zeros(8, 9, device=dev))
    with pytest.raises(TypeError):
        kernels.volume_lookup(tab.to(torch.int32), f)
    # past the item cap the rows go in chunks (here 1024 rows a launch,
    # the last one 3 rows), bit-equal to one launch
    monkeypatch.setattr(kernels, "MAX_ITEMS", 1024 * 128)
    before = kernels.launches["volume_lookup"]
    chunked = kernels.volume_lookup(tab, f)
    assert kernels.launches["volume_lookup"] == before + 5
    assert torch.equal(chunked, out)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [9, 16, 36, 64, 5])
@pytest.mark.parametrize("d", [256, 384, 512])
def test_kernel_b_deep_tables_match_plain(d, s):
    """Kernel B on the per-plane build's deeper tables (D passed at run
    time), with fields below 0, above D - 2 and at exact integers, and on
    a table the per-plane build made on the card (image-order rows)."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    p = 4099
    tab = _u16(rng.integers(0, 65536, (p, d))).to(dev)
    f = _field(rng, (p, s), -3, d + 2, dev)
    out = vol.volume_lookup(tab, f)
    with kernels.plain_versions():
        ref = vol.volume_lookup(tab, f)
    assert torch.equal(out, ref)
    sc, geom, src = _scene(dev)
    vt = vol.build_volume_tables(
        geom, src, torch.tensor(sc.d_min, device=dev),
        torch.tensor(sc.d_max, device=dev), n_chunks=d // 128)
    f = _field(rng, (vt.tab.shape[1], s), -3, d + 2, dev)
    out = vol.volume_lookup(vt.tab[1], f)
    with kernels.plain_versions():
        ref = vol.volume_lookup(vt.tab[1], f)
    assert torch.equal(out, ref)
    with kernels.earlier_designs(), pytest.raises(ValueError):
        kernels.volume_lookup(tab, f[:p])


@pytest.mark.gpu
def test_kernel_c_matches_plain():
    dev = _cuda()
    sc, geom, _ = _scene(dev)
    rng = np.random.default_rng(8)
    depth = torch.from_numpy(rng.uniform(sc.d_min, sc.d_max, (V, H, W))
                             .astype(np.float32)).to(dev)
    n = torch.from_numpy(rng.standard_normal((V, 3, H, W)).astype(
        np.float32)).to(dev)
    n = n / n.norm(dim=1, keepdim=True)
    ctx = rg.build_rect_context(geom, rg.pack_depth_normals(depth, n))
    sigma = torch.from_numpy((1.0 / rng.uniform(
        sc.d_min, sc.d_max, (H, W))).astype(np.float32)).to(dev)
    before = kernels.launches["rect_lookup"]
    out = rg.rect_lookup(ctx, sigma)
    assert kernels.launches["rect_lookup"] == before + 1
    with kernels.plain_versions():
        ref = rg.rect_lookup(ctx, sigma)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (out[:, 0] != 0).float().mean() > 0.5


def _zncc_case(device, v=3, h=40, w=48, pad=5, step=2,
               halfwins=(3.0, 5.0)):
    """Kernel E's arguments with the scan offsets of the warped scoring
    at patch step ``step`` (2: full sampling, 32 offsets; 4: explore, 8),
    the window corners left out as ``score.warped_inputs`` does."""
    rng = np.random.default_rng(11)
    hp, wp = h + 2 * pad, w + 2 * pad
    f32 = np.float32
    arrs = dict(ref_pad=rng.random((hp, wp)), tm=rng.random((h, w)),
                nsq0=rng.random((h, w)) + 0.1,
                warped_pad=rng.random((v, hp, wp)),
                valid_pad=rng.random((v, hp, wp)) > 0.1,
                hw=rng.choice(halfwins, (h, w)),
                acc=rng.random((v, 4, h, w)) * 0.1)
    args = {k: torch.from_numpy(a.astype(f32)).to(device)
            for k, a in arrs.items()}
    offs = [(dy, dx) for dy in range(-pad, pad + 1, step)
            for dx in range(-pad, pad + 1, step)
            if not (abs(dy) == pad and abs(dx) == pad)]
    return dict(args, scan_offsets=tuple(offs), pad=pad)


def test_launchers_d_and_e_refuse_cpu_tensors():
    tab = _u16(np.zeros((64, 128)))
    with pytest.raises(ValueError):
        kernels.volume_lookup_multi(tab, _u16(np.zeros((64, 81))))
    with pytest.raises(ValueError):
        kernels.zncc_warped(**_zncc_case("cpu"))
    # the dispatching wrappers take the plain versions for CPU tensors
    before = dict(kernels.launches)
    vol.volume_lookup_multi(tab, _u16(np.zeros((64, 81))))
    zw.zncc_warped(**_zncc_case("cpu"))
    assert kernels.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("c", [81, 324, 7])
@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("mode", ["f32", "packed", "bounded"])
def test_kernel_d_matches_plain(mode, d, c, monkeypatch):
    """Kernel D in each mode, at each table depth, at the paths' column
    counts and a small one (7, whose field starts one element past the
    allocation: the unaligned, scalar walk), on a row count that is a
    multiple of no tile; bounded rows whose interval holds none of the
    field read no tap and give the sentinel throughout."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    p = 4099
    offset = 1 if c == 7 else 0
    tab = _u16(rng.integers(0, 65536, (p, d))).to(dev)
    bounds = None
    if mode == "f32":
        f = _field(rng, (p, c), -3, d + 2, dev, offset)
    else:
        enc = rng.integers(0, (d - 1) * vol.F_PACK_SCALE + 1, p * c + offset)
        enc[::c] = 65535                          # beyond-grid sentinel
        f = _u16(enc).to(dev)[offset:].view(p, c)
    if mode == "bounded":
        lo = rng.integers(0, 40 * vol.F_PACK_SCALE, p)
        hi = rng.integers(60 * vol.F_PACK_SCALE, 65535, p)
        lo[::5], hi[::5] = 65535, 65534           # empty: every item out
        lo[1::5], hi[1::5] = 0, 0
        bounds = _u16(np.concatenate(
            [np.repeat(lo[:, None], 64, 1), np.repeat(hi[:, None], 64, 1)],
            axis=1)).to(dev)
    before = kernels.launches["volume_lookup_multi"]
    out = vol.volume_lookup_multi(tab, f, bounds)
    assert kernels.launches["volume_lookup_multi"] == before + 1
    with kernels.plain_versions():
        ref = vol.volume_lookup_multi(tab, f, bounds)
    if mode == "f32":
        assert torch.equal(out, ref)
    else:
        # beyond the grid the unbounded lerp extrapolates, rounded as the
        # plain version rounds it op by op (--fmad=false)
        assert torch.equal(vol.u16_as_int32(out), vol.u16_as_int32(ref))
    if mode == "bounded":
        assert bool((vol.u16_as_int32(out[::5]) == 65535).all())
        with pytest.raises(ValueError):           # bounds need u16
            kernels.volume_lookup_multi(tab, f.to(torch.float32), bounds)
    with pytest.raises(ValueError):               # not contiguous
        kernels.volume_lookup_multi(tab, f[:, ::2])
    # past the item cap the rows go in chunks (1024 rows a launch, the
    # last one 3 rows), equal to one launch
    monkeypatch.setattr(kernels, "MAX_ITEMS", 1024 * max(c, d))
    before = kernels.launches["volume_lookup_multi"]
    chunked = kernels.volume_lookup_multi(tab, f, bounds)
    assert kernels.launches["volume_lookup_multi"] == before + 5
    assert torch.equal(chunked.view(torch.int16), out.view(torch.int16))


def _plain_by_rows(fn, rows: int, *arrays):
    """A row-wise plain version over slices of ``rows`` rows, joined (at
    2 G items its int64 temporaries would not fit the card at once)."""
    p = arrays[0].shape[0]
    return torch.cat([fn(*(None if a is None else a[r:r + rows]
                           for a in arrays)) for r in range(0, p, rows)])


def _random_u16(shape, hi: int, dev) -> torch.Tensor:
    return torch.randint(0, hi, shape, dtype=torch.int32,
                         device=dev).to(torch.uint16)


@pytest.mark.gpu
def test_kernel_b_past_the_item_cap():
    """Kernel B on a 512-plane table of 4,300,000 rows (2.2 G entries,
    4.4 GB; one launch takes 2^31 - 1): two row chunks, bit-equal to the
    plain version."""
    dev = _cuda()
    torch.manual_seed(0)
    p, s, d = 4_300_000, 9, 512
    assert p * d > kernels.MAX_ITEMS
    tab = torch.randint(-32768, 32768, (p, d), dtype=torch.int16,
                        device=dev).view(torch.uint16)
    f = torch.rand(p, s, device=dev) * (d + 4) - 2
    before = kernels.launches["volume_lookup"]
    out = vol.volume_lookup(tab, f)
    assert kernels.launches["volume_lookup"] == before + 2
    assert torch.equal(out, _plain_by_rows(vol.volume_lookup_plain,
                                           500_000, tab, f))


@pytest.mark.gpu
def test_kernel_d_past_the_item_cap():
    """Kernel D, packed and bounded, at 576 columns (9 candidates x 64
    offsets) on 3,800,000 rows (2.19 G items, a 4.4 GB field): two row
    chunks, equal to the plain version."""
    dev = _cuda()
    torch.manual_seed(1)
    p, c, d = 3_800_000, 576, 128
    assert p * c > kernels.MAX_ITEMS
    tab = torch.randint(-32768, 32768, (p, d), dtype=torch.int16,
                        device=dev).view(torch.uint16)
    f = _random_u16((p, c), (d - 1) * vol.F_PACK_SCALE + 1, dev)
    lo = torch.randint(0, 40 * vol.F_PACK_SCALE, (p, 1), device=dev)
    hi = torch.randint(60 * vol.F_PACK_SCALE, 65535, (p, 1), device=dev)
    bounds = torch.cat([lo.expand(p, 64), hi.expand(p, 64)],
                       1).to(torch.uint16)
    before = kernels.launches["volume_lookup_multi"]
    out = vol.volume_lookup_multi(tab, f, bounds)
    assert kernels.launches["volume_lookup_multi"] == before + 2
    ref = _plain_by_rows(vol.volume_lookup_multi_plain, 400_000, tab, f,
                         bounds)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.gpu
def test_kernel_e_past_128_offsets():
    """Kernel E with the 140 offsets of adapt_half_window 11 at patch
    step 2 (pad 11, the corners left out), 3 views at 960 x 1280: exact
    against the plain version."""
    dev = _cuda()
    case = _zncc_case(dev, v=3, h=960, w=1280, pad=11, step=2,
                      halfwins=(5.0, 11.0))
    assert len(case["scan_offsets"]) == 140
    out_s, out_v = zw.zncc_warped(**case)
    with kernels.plain_versions():
        ref_s, ref_v = zw.zncc_warped(**case)
    assert torch.equal(out_s, ref_s) and torch.equal(out_v, ref_v)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["volume_lookup", "volume_lookup_multi"])
def test_earlier_designs_match_current(kernel):
    """Inside ``earlier_designs()`` kernels B and D launch the designs
    they replaced, which compute the same values."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    tab = _u16(rng.integers(0, 65536, (1000, 128))).to(dev)
    f = _field(rng, (1000, 36), -3, 130, dev)
    launch = getattr(kernels, kernel)
    out = launch(tab, f)
    with kernels.earlier_designs():
        earlier = launch(tab, f)
    assert kernels.earlier_library() is not kernels.library()
    assert torch.equal(out, earlier)


@pytest.mark.gpu
def test_kernel_e_matches_plain():
    dev = _cuda()
    case = _zncc_case(dev)
    before = kernels.launches["zncc_warped"]
    out_s, out_v = zw.zncc_warped(**case)
    assert kernels.launches["zncc_warped"] == before + 1
    with kernels.plain_versions():
        ref_s, ref_v = zw.zncc_warped(**case)
    assert torch.equal(out_s, ref_s) and torch.equal(out_v, ref_v)
    with pytest.raises(ValueError):                     # beyond the pad
        kernels.zncc_warped(**dict(
            case, scan_offsets=case["scan_offsets"] + ((6, 0),)))
    # more views than a launch holds: chunks of ZNCC_MAX_VIEWS, each view
    # as its plain version computes it
    case12 = _zncc_case(dev, v=12)
    before = kernels.launches["zncc_warped"]
    out_s, out_v = zw.zncc_warped(**case12)
    assert kernels.launches["zncc_warped"] == before + 2
    assert out_s.shape == (12, 40, 48)
    with kernels.plain_versions():
        ref_s, ref_v = zw.zncc_warped(**case12)
    assert torch.equal(out_s, ref_s) and torch.equal(out_v, ref_v)


@pytest.mark.gpu
@pytest.mark.parametrize("v", [1, 3, 5])
@pytest.mark.parametrize("step", [2, 4])
def test_kernel_e_tiles_match_plain(v, step):
    """Kernel E's 32 x 8 pixel tiles on a frame that is a multiple of
    neither side, every view count in one launch, both scan-offset sets
    at pad 5, and half-windows small enough that the window masks
    offsets."""
    dev = _cuda()
    case = _zncc_case(dev, v=v, h=37, w=45, step=step,
                      halfwins=(1.0, 2.0, 3.0, 5.0))
    assert len(case["scan_offsets"]) == {2: 32, 4: 8}[step]
    out_s, out_v = zw.zncc_warped(**case)
    with kernels.plain_versions():
        ref_s, ref_v = zw.zncc_warped(**case)
    assert torch.equal(out_s, ref_s) and torch.equal(out_v, ref_v)


@pytest.mark.gpu
def test_zero_baseline_pair_matches_plain():
    """A view paired with itself (what ``select_neighbors`` gives an
    isolated view) has a singular rectification: NaN/inf in its rect
    homography.  Kernels A, B and C read the fields built from it without
    a fault, and the scene's sweeps stay finite and agree with their plain
    versions' (depth within 1e-3 on >= 99% of pixels, as an argmin
    between near-tied candidates may flip)."""
    from hcmvs_tpu_torch.core.config import DenseConfig
    from hcmvs_tpu_torch.dense.scene_driver import (SceneTensors,
                                                    estimate_scene)
    dev = _cuda()
    sc = make_plane_scene(np.random.default_rng(4), h=H, w=W, n_views=3)
    cams = Camera(*(torch.stack([getattr(c, f) for c in sc.cameras])
                    for f in "KRC")).to(dev)
    scene = SceneTensors(
        gray=torch.from_numpy(np.stack(sc.images)).to(dev), cams=cams,
        nbr_idx=torch.tensor([[1, 2], [0, 2], [2, 2]], device=dev),
        nbr_valid=torch.tensor([[True, True], [True, True],
                                [False, False]], device=dev),
        d_min=torch.full((3,), sc.d_min, device=dev),
        d_max=torch.full((3,), sc.d_max, device=dev))
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3, patch_step=2,
                      estimation_iters=1, estimation_iters_external=2,
                      random_iters=2, use_optical_flow=0, optimize=0)
    before = dict(kernels.launches)
    out = estimate_scene(torch.Generator(device=dev).manual_seed(0), scene,
                         cfg)
    for name in ("rect_build", "volume_lookup", "rect_lookup"):
        assert kernels.launches[name] > before[name]
    with kernels.plain_versions():
        ref = estimate_scene(torch.Generator(device=dev).manual_seed(0),
                             scene, cfg)
    torch.cuda.synchronize()
    for x in (out.depth, out.normal, out.cost):
        assert torch.isfinite(x).all()
    close = (out.depth - ref.depth).abs() <= 1e-3 * ref.depth.abs()
    assert close.float().mean() >= 0.99


def _refine_setup():
    """A ridge seen by 4 views and a noisy 14x14 grid on it (the setup of
    tests/test_torch_refine.py)."""
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    sc = make_ridge_scene(np.random.default_rng(7), h=96, w=128,
                          n_views=4, spacing=0.3)
    n = 14
    X, Y = np.meshgrid(np.linspace(-1.3, 1.3, n), np.linspace(-1.0, 1.0, n))
    Z = np.where(X < 0, 4.0 + 0.5 * X, 4.0 - 0.35 * X)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1).astype(np.float32)
    verts[:, 2] += np.random.default_rng(0).uniform(
        -0.06, 0.06, len(verts)).astype(np.float32)
    faces = np.asarray([f for j in range(n - 1) for i in range(n - 1)
                        for f in ([j * n + i, j * n + i + 1, j * n + i + n],
                                  [j * n + i + 1, j * n + i + n + 1,
                                   j * n + i + n])], np.int32)
    Ks, Rs, Cs = (np.stack([np.asarray(getattr(c, f)) for c in sc.cameras])
                  for f in "KRC")
    return (verts, faces, np.stack(sc.images), Ks, Rs, Cs,
            np.array([[0, 1], [0, 2], [0, 3], [1, 2]]))


@pytest.mark.gpu
def test_refine_on_cuda_is_reproducible_and_matches_cpu():
    """Refine's sums run in a fixed order on CUDA: two runs give equal
    vertices.  One gradient on the card agrees with the CPU's within 1e-4
    (relative L2), the bar of chip_smoke.py's phase 15."""
    from hcmvs_tpu_torch.mesh import refine as R
    from hcmvs_tpu_torch.mesh.mesh_ops import rasterize_attributes
    dev = _cuda()
    args = _refine_setup()
    kw = dict(scales=2, iters_per_scale=3, reg_weight=0.1)
    a = R.refine_mesh(*args, device=dev, **kw)
    b = R.refine_mesh(*args, device=dev, **kw)
    assert np.array_equal(a, b) and np.isfinite(a).all()
    verts, faces, images, Ks, Rs, Cs, pairs = args
    h, w = images.shape[1:]
    out = [rasterize_attributes(verts.astype(np.float64), faces, Ks[i],
                                Rs[i], Cs[i], h, w) for i in range(4)]
    dep, fid, bar = (np.stack(x) for x in zip(*out))
    grads = []
    for d in (torch.device("cpu"), dev):
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa
                                      device=d)
        imgs = t(images)
        gx, gy = R.image_gradients(imgs)
        F = torch.as_tensor(faces.astype(np.int64), device=d)
        ras = R.ScaleRasters(torch.as_tensor(fid, device=d).long(), t(bar),
                             t(dep), len(faces))
        g, ws = R.raster_refine_grad(t(verts), F, ras, imgs, gx, gy, t(Ks),
                                     t(Rs), t(Cs), pairs,
                                     R.VertexSum(F, len(verts), len(pairs)))
        grads.append((g.cpu().numpy(), ws.cpu().numpy()))
    (g0, w0), (g1, w1) = grads
    assert np.linalg.norm(g1 - g0) <= 1e-4 * np.linalg.norm(g0)
    assert np.linalg.norm(w1 - w0) <= 1e-4 * np.linalg.norm(w0)


@pytest.mark.gpu
def test_lbp_labels_on_cuda_match_cpu():
    from hcmvs_tpu_torch.mesh.texture import label_faces_lbp
    dev = _cuda()
    _, faces, *_ = _refine_setup()
    rng = np.random.default_rng(0)
    qual = rng.uniform(0, 1, (len(faces), 4)).astype(np.float32)
    a = label_faces_lbp(faces, qual, device=dev)
    assert np.array_equal(a, label_faces_lbp(faces, qual, device=dev))
    assert (a == label_faces_lbp(faces, qual, device="cpu")).mean() >= 0.999


@pytest.mark.gpu
def test_bundle_adjustment_on_cuda_is_reproducible_and_matches_cpu():
    """BA's segment sums run in a fixed order on CUDA: two LM runs give
    equal states.  One PCG step on the card agrees with the CPU's within
    1e-4 (relative to the step)."""
    from hcmvs_tpu_torch.eval.ba_bench import make_problem
    from hcmvs_tpu_torch.sfm.ba import ba_step, run_ba
    dev = _cuda()
    pc, sc, _ = make_problem(30, 1500, device="cpu")
    pg, sg, _ = make_problem(30, 1500, device=dev)
    a, _ = run_ba(pg, sg, n_iters=3)
    b, _ = run_ba(pg, sg, n_iters=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    step_c = ba_step(pc, sc, np.float32(1e-3))
    step_g = ba_step(pg, sg, np.float32(1e-3))
    for x0, xc, xg in zip(sc, step_c, step_g):
        move = (xc - x0).abs().max()
        assert (xg.cpu() - xc).abs().max() <= 1e-4 * move


@pytest.mark.gpu
def test_sfm_features_and_ransac_on_cuda_match_cpu():
    """The detector keeps its keypoint slots on the card; the essential
    RANSAC fed the same draws finds the same inliers and pose."""
    from hcmvs_tpu_torch.sfm import two_view as tv
    from hcmvs_tpu_torch.sfm.features import detect_and_describe_pyramid
    from hcmvs_tpu_torch.utils.synth import make_ridge_scene
    dev = _cuda()
    img = make_ridge_scene(np.random.default_rng(1), h=192, w=256,
                           n_views=1).images[0]
    kc = detect_and_describe_pyramid(torch.from_numpy(img), 512)
    kg = detect_and_describe_pyramid(torch.from_numpy(img).to(dev), 512)
    valid = kc.score > 0
    assert valid.sum() > 50
    assert torch.equal(kg.score.cpu() > 0, valid)
    assert (kg.xy.cpu() - kc.xy).abs().max() <= 1e-3
    assert (kg.desc.cpu() - kc.desc)[valid].abs().max() <= 1e-4
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (200, 3)) + [0, 0, 4.0]
    t = np.array([0.5, 0.05, 0.02]) / np.linalg.norm([0.5, 0.05, 0.02])
    p0 = X[:, :2] / X[:, 2:3] + rng.normal(0, 1e-3, (200, 2))
    X1 = X + t
    p1 = X1[:, :2] / X1[:, 2:3] + rng.normal(0, 1e-3, (200, 2))
    p1[:40] = rng.uniform(-0.5, 0.5, (40, 2))
    p0, p1 = (torch.from_numpy(p.astype(np.float32)) for p in (p0, p1))
    ok = torch.ones(200, dtype=torch.bool)
    idx = tv.draw_samples(torch.Generator().manual_seed(0), ok, 512, 8)
    rc = tv.ransac_essential(idx, p0, p1, ok, 2e-5)
    rg_ = tv.ransac_essential(idx.to(dev), p0.to(dev), p1.to(dev),
                              ok.to(dev), 2e-5)
    assert int(rg_.n_inliers) == int(rc.n_inliers) >= 150
    assert (rg_.R.cpu() - rc.R).abs().max() <= 1e-4
    assert (rg_.t.cpu() - rc.t).abs().max() <= 1e-4


@pytest.mark.gpu
def test_jpeg_fixtures_match_their_manifest_on_the_card_machine():
    """The port's decodes of every committed fixture of tests/data/jpeg
    (native/jpeg.cpp, built on first use) equal the manifest's cv2
    digests on the card's machine, where no cv2 exists; the photos' gray
    decodes then go to the card."""
    import hashlib
    import json
    from hcmvs_tpu_torch.io.images import imread
    dev = _cuda()
    root = Path(__file__).resolve().parent / "data" / "jpeg"
    manifest = json.loads((root / "manifest.json").read_text())["files"]
    for name, digests in manifest.items():
        for mode, want in digests.items():
            img = imread(str(root / name), mode)
            assert list(img.shape) == want["shape"], (name, mode)
            assert hashlib.sha256(img.tobytes()).hexdigest() \
                == want["sha256"], (name, mode)
    gray = torch.from_numpy(imread(str(root / "photos" / "p00.jpg"),
                                   "gray")).to(dev)
    assert gray.shape == (960, 1280) and int(gray.max()) > 0
