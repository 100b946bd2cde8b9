"""The coarse stage of the port's visibility walk (K1 and K2): the per-pair
sub-block masks of `render_fused.subblock_masks_plain`, the plain-torch twin
of `csrc/raster_common.cuh` `subblock_mask`.

  (a) conservative: no pixel that `geometry.coverage_and_depth` covers lies
      in a sub-block whose bit is clear: seeded soups, triangle grids whose
      shared edges run through pixel centres and along sub-block borders,
      and hypothesis-made coefficients of large magnitude (products that
      overflow to inf, sums that become NaN);
  (b) exact: the plain winner restricted to the masked triangles equals
      `rasterize_pallas_plain`'s z and tri bit for bit, whole frames and
      ragged shards with non-zero offsets;
  (c) useful: on a soup of config 5's triangle size under 60% of the bits
      are set (a mask of all ones would pass (a) and (b)).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_raster import _scene, _screen_tris, _setup
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import geometry as pgeo
from dtrenderer_tpu_torch.ops import raster_pallas as prp
from dtrenderer_tpu_torch.ops import render_fused as prf

CPU = torch.device("cpu")
# (y_offset, x_offset, height, width); None = the whole frame. The shards'
# sizes are multiples of neither the tile nor the sub-block.
SHARDS = [None, (24, 37, 41, 91), (19, 43, 37, 50)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several pytest workers on a few cores; torch's
    intra-op pool in each of them would oversubscribe the cores, and these
    small eager tensors gain nothing from it. Values do not depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(case):
    """-> (TriSetup, h, w): the soups of test_torch_raster.py and the
    shared-edge grids."""
    if case in stress.CASES:
        corners, h, w = stress.CASES[case]()
        return stress.setup(corners, h, w, CPU), h, w
    screen, faces, h, w, cull = _scene(case)
    return _setup(screen, faces, h, w, cull), h, w


def _pair_tiles(bins):
    counts = (bins.tile_start[1:] - bins.tile_start[:-1]).long()
    return torch.repeat_interleave(torch.arange(counts.numel()), counts)


def _pixel_bits(bins):
    """The mask bit of each tile pixel's sub-block, i32 [P]."""
    p = torch.arange(bins.tile_h * bins.tile_w)
    sub = (p // bins.tile_w // prf.SUB_H) * (bins.tile_w // prf.SUB_W) + (
        p % bins.tile_w) // prf.SUB_W
    return (1 << sub).to(torch.int32)


def _assert_conservative(coef, bins, h, w, y0, x0):
    """Returns (covered pixel-pairs, set bits, pairs)."""
    masks = prf.subblock_masks_plain(coef, bins, h, w, y0, x0)
    assert masks.dtype == torch.int32
    assert masks.shape == bins.tri_ids.shape
    assert bool(((masks >= 0) & (masks < 1 << prf.SUBS)).all())
    px, py = prf.tile_pixel_centres(bins, h, w, y0, x0, CPU)
    tile = _pair_tiles(bins)
    inside, _, _ = pgeo.coverage_and_depth(
        coef[bins.tri_ids.long()][:, None, :], px[tile], py[tile])
    allowed = (masks[:, None] & _pixel_bits(bins)[None, :]) != 0
    lost = inside & ~allowed
    assert not bool(lost.any()), f"{int(lost.sum())} covered pixels masked"
    bits = sum(int(((masks >> s) & 1).sum()) for s in range(prf.SUBS))
    return int(inside.sum()), bits, masks.numel()


def _masked_winner(coef, bins, h, w, y0, x0):
    """render_fused.winner_plain, taking a triangle at a pixel only where
    its pair's mask has the bit of the pixel's sub-block -> (z, tri)."""
    masks = prf.subblock_masks_plain(coef, bins, h, w, y0, x0)
    px, py = prf.tile_pixel_centres(bins, h, w, y0, x0, CPU)
    bit = _pixel_bits(bins)[None, :]
    bz = torch.full(px.shape, float("inf"))
    bid = torch.full(px.shape, torch.iinfo(torch.int32).max,
                     dtype=torch.int32)
    starts = bins.tile_start[:-1].long()
    for s, (has, ids) in enumerate(prf.binned_slots(bins)):
        pair = torch.clamp(starts + s, max=max(masks.numel() - 1, 0))
        kept = (masks[pair][:, None] & bit) != 0
        inside, z, _ = pgeo.coverage_and_depth(coef[ids][:, None, :], px, py)
        ids = ids.to(torch.int32)[:, None]
        take = (inside & kept & has[:, None]
                & ((z < bz) | ((z == bz) & (ids < bid))))
        bz = torch.where(take, z, bz)
        bid = torch.where(take, ids, bid)
    z = prf.tiles_to_image(bz, bins, h, w)
    tri = torch.where(z == float("inf"), -1,
                      prf.tiles_to_image(bid, bins, h, w))
    return z, tri


SOUPS = ["small", "mixed_sizes", "depth_ties", *sorted(stress.CASES)]


@pytest.mark.parametrize("shard", SHARDS, ids=["full", "shard_a", "shard_b"])
@pytest.mark.parametrize("case", SOUPS)
def test_masks_are_conservative(case, shard):
    setup, h, w = _case(case)
    y0, x0, h, w = shard if shard is not None else (0, 0, h, w)
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, h, w, y0,
                              x0)
    covered, bits, pairs = _assert_conservative(setup.coef, bins, h, w, y0,
                                                x0)
    assert covered > 100 and 0 < bits <= prf.SUBS * pairs


@pytest.mark.parametrize("shard", SHARDS, ids=["full", "shard_a", "shard_b"])
@pytest.mark.parametrize("case", SOUPS)
def test_masked_winner_equals_the_plain_twin(case, shard):
    setup, h, w = _case(case)
    y0, x0, h, w = shard if shard is not None else (0, 0, h, w)
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, h, w, y0,
                              x0)
    z_m, t_m = _masked_winner(setup.coef, bins, h, w, y0, x0)
    z_p, t_p = prp.rasterize_pallas_plain(setup.coef, bins, h, w, y0, x0)
    assert int((t_p >= 0).sum()) > 100
    assert torch.equal(z_m.view(torch.int32), z_p.view(torch.int32))
    assert torch.equal(t_m, t_p)


def test_deep_tile_needs_three_staging_chunks():
    """The deep-tile case is what takes the kernels' walk through more than
    two chunks of 256 staged triangles."""
    setup, h, w = _case("deep_tile")
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, h, w)
    assert int((bins.tile_start[1:] - bins.tile_start[:-1]).max()) > 512


def test_masks_reject_most_bits_of_a_config5_like_soup():
    """Triangles of config 5's size on the screen (bboxes about 28 pixels):
    the edges alone clear well over 40% of the sub-block bits, and whole
    pairs that the bbox binned but the triangle never touches."""
    screen, faces = _screen_tris(70, 400, 128, 256, size=14)
    setup = _setup(screen, faces, 128, 256, False)
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, 128, 256)
    covered, bits, pairs = _assert_conservative(setup.coef, bins, 128, 256,
                                                0, 0)
    assert covered > 10000 and pairs > 1000
    assert bits / (prf.SUBS * pairs) < 0.6
    masks = prf.subblock_masks_plain(setup.coef, bins, 128, 256)
    assert int((masks == 0).sum()) > 0.1 * pairs


def test_masks_need_the_kernels_tile():
    screen, faces, h, w, cull = _scene("small")
    setup = _setup(screen, faces, h, w, cull)
    bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, h, w, 0, 0,
                              32, 32)
    with pytest.raises(ValueError, match="16x16"):
        prf.subblock_masks_plain(setup.coef, bins, h, w)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), log_mag=st.integers(-3, 38),
       offset=st.sampled_from([0, 7, 4096, 1 << 20]))
def test_masks_are_conservative_for_large_coefficients(seed, log_mag, offset):
    """Coefficients up to the top of the f32 range, in one tile: products
    overflow to inf and sums of opposite infinities become NaN; some rows
    are made to vanish exactly at a pixel centre. A cleared bit must still
    mean that no pixel of the sub-block passes."""
    rng = np.random.default_rng(seed)
    T = 64
    coef = np.zeros((T, 16), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        ab = (rng.uniform(-1, 1, (T, 6)) * 10.0 ** rng.uniform(
            log_mag - 6, log_mag, (T, 6))).astype(np.float32)
        # a third of the rows get small-integer A, B and a C that puts the
        # edge exactly through a pixel centre (E == 0 decided by tl)
        exact = rng.integers(0, 3, T) == 0
        ab[exact] = rng.integers(-3, 4, (int(exact.sum()), 6))
        cx = offset + rng.integers(0, 16, (T, 3)) + 0.5
        cy = offset + rng.integers(0, 16, (T, 3)) + 0.5
        c = -(ab[:, 0::2].astype(np.float64) * cx
              + ab[:, 1::2].astype(np.float64) * cy)
        c = np.where(exact[:, None], c, c * rng.uniform(0.5, 1.5, (T, 3)))
        coef[:, 0:9:3], coef[:, 1:9:3] = ab[:, 0::2], ab[:, 1::2]
        coef[:, 2:9:3] = c.astype(np.float32)
    coef[:, 9:13] = rng.uniform(0.1, 1.0, (T, 4))
    coef[:, 13:16] = rng.integers(0, 2, (T, 3))
    bins = pbin.Bins(torch.tensor([0, T], dtype=torch.int32),
                     torch.arange(T, dtype=torch.int32),
                     torch.zeros((), dtype=torch.int32), prf.TILE_H,
                     prf.TILE_W)
    _assert_conservative(torch.tensor(coef), bins, 16, 16, offset, offset)
