"""PyTorch port's CSR binning vs the JAX reference's dense bins.

The port bins every in-shard triangle into every tile of its bbox's tile
span, with no capacity and no small/broad split. The reference's dense bins
hand every broad triangle to every tile, so the per-tile id sets agree only
for scenes without broads: each case sets `small_span` to the widest span in
the scene. The reference's ids are read from its id channel
(SETUP_ID_CHANNEL) and counts, as test_flat_binning_matches_dense_sets does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dtrenderer_tpu.models import primitives
from dtrenderer_tpu.ops import render_fused as jrf
from dtrenderer_tpu.ops.binning import SETUP_ID_CHANNEL
from dtrenderer_tpu.ops.pipeline import prepare_draw
from dtrenderer_tpu.ops.shading import make_light
from dtrenderer_tpu.utils import math3d as m3
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.ops import binning as pbin

CPU = torch.device("cpu")
H, W = 128, 256
PROJ = jnp.asarray(m3.perspective(np.pi / 3, W / H, 0.1, 50.0))


def _scene(seed, n=600, extent=1.2):
    soup = primitives.random_triangle_soup(n, rng_seed=seed, extent=extent)
    mdl = jnp.asarray(m3.model_matrix((0, 0, -3.0), m3.rotate_y(0.4)))
    setup, _ = prepare_draw(soup, mdl, PROJ, m3.mat4mul(PROJ, mdl), mdl,
                            make_light(), (1, 1, 1, 1), "gouraud", W, H, True,
                            False)
    return setup


def _port_sets(bins):
    start = bins.tile_start.numpy()
    ids = bins.tri_ids.numpy()
    return [ids[start[t]:start[t + 1]] for t in range(len(start) - 1)]


def _span(bbox, valid, tile_h, tile_w):
    b = np.asarray(bbox)[np.asarray(valid)]
    if not len(b):
        return 1
    return int(((b[:, 2] // tile_w - b[:, 0] // tile_w + 1)
                * (b[:, 3] // tile_h - b[:, 1] // tile_h + 1)).max())


@pytest.mark.parametrize("seed,shard", [(29, None), (31, None),
                                        (29, (40, 96, 72, 128)),
                                        (37, (0, 128, 128, 128))])
def test_tile_id_sets_match_reference(seed, shard):
    """shard = (y_offset, x_offset, height, width) of a band/tile of the
    frame, or None for the whole frame."""
    setup = _scene(seed)
    y0, x0, h, w = shard if shard is not None else (0, 0, H, W)
    th, tw = 32, 128
    # the reference's in-shard test + localisation, for the span
    local = np.stack([np.clip(np.asarray(setup.bbox)[:, 0] - x0, 0, w - 1),
                      np.clip(np.asarray(setup.bbox)[:, 1] - y0, 0, h - 1),
                      np.clip(np.asarray(setup.bbox)[:, 2] - x0, 0, w - 1),
                      np.clip(np.asarray(setup.bbox)[:, 3] - y0, 0, h - 1)], 1)
    span = _span(local, setup.valid, th, tw)
    ref, dropped = jrf.prepare_draw_bins(
        setup.coef, setup.bbox, setup.valid, None, h, w, y0, x0, tile_h=th,
        tile_w=tw, capacity=1024, small_span=span, broad_cap=8,
        use_ybounds=False)
    assert int(ref.overflow) == 0 and int(dropped) == 0
    counts = np.asarray(ref.counts)
    ids_ref = np.asarray(ref.setup)[..., SETUP_ID_CHANNEL].view(np.int32)

    got = pbin.bin_triangles(convert.tensor(setup.coef, CPU),
                             convert.tensor(setup.bbox, CPU, np.int32),
                             convert.tensor(setup.valid, CPU, bool),
                             h, w, y0, x0, th, tw)
    sets = _port_sets(got)
    assert len(sets) == counts.size
    assert int(got.overflow) == 0
    n_pairs = 0
    for t, ids in enumerate(sets):
        ty, tx = divmod(t, counts.shape[1])
        want = np.sort(ids_ref[ty, tx, :counts[ty, tx]])
        np.testing.assert_array_equal(ids, want, err_msg=f"tile {(ty, tx)}")
        assert np.all(np.diff(ids) > 0), "ids must ascend within a tile"
        n_pairs += len(ids)
    assert n_pairs == got.tri_ids.shape[0] > 0


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)])
def test_bins_match_bbox_enumeration(tile):
    """Kernel-sized tiles: each tile holds exactly the in-frame triangles
    whose clamped bbox overlaps it, ids ascending (a direct enumeration)."""
    th, tw = tile
    setup = _scene(41, n=400, extent=1.6)
    coef = convert.tensor(setup.coef, CPU)
    bbox = convert.tensor(setup.bbox, CPU, np.int32)
    valid = convert.tensor(setup.valid, CPU, bool)
    got = _port_sets(pbin.bin_triangles(coef, bbox, valid, H, W, 0, 0, th, tw))
    b = bbox.numpy()
    n_tx = -(-W // tw)
    want = [[] for _ in got]
    for i in np.nonzero(valid.numpy())[0]:
        for ty in range(b[i, 1] // th, b[i, 3] // th + 1):
            for tx in range(b[i, 0] // tw, b[i, 2] // tw + 1):
                want[ty * n_tx + tx].append(i)
    for t, (g, wnt) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(wnt, np.int32),
                                      err_msg=f"tile {t}")


def test_empty_and_offscreen_scenes():
    coef = torch.zeros((5, 16))
    bbox = torch.tensor([[0, 0, 10, 10]] * 5, dtype=torch.int32)
    for valid in (torch.zeros(5, dtype=torch.bool),
                  torch.ones(5, dtype=torch.bool)):
        # second case: the whole scene lies left of a shard at x >= 64
        bins = pbin.bin_triangles(coef, bbox, valid, 32, 32, 0, 64, 16, 16)
        assert bins.tri_ids.shape == (0,)
        assert bins.tile_start.tolist() == [0] * 5
    bins = pbin.bin_triangles(coef, bbox, torch.ones(5, dtype=torch.bool),
                              32, 32, 0, 0, 16, 16)
    assert bins.tile_start.tolist() == [0, 5, 5, 5, 5]
    assert bins.tri_ids.tolist() == [0, 1, 2, 3, 4]


# ------------------------------------------------- cross-band binning


def _random_setup(rng, n, h, w, p_valid=0.9):
    """Random bboxes in frame pixels (some spanning several bands, some one
    pixel) and a random valid mask."""
    x0 = rng.integers(0, w, n)
    y0 = rng.integers(0, h, n)
    x1 = np.minimum(x0 + rng.integers(0, w // 2, n) * (rng.random(n) < 0.3)
                    + rng.integers(0, 6, n), w - 1)
    y1 = np.minimum(y0 + rng.integers(0, h, n) * (rng.random(n) < 0.2)
                    + rng.integers(0, 6, n), h - 1)
    bbox = torch.tensor(np.stack([x0, y0, x1, y1], 1).astype(np.int32))
    valid = torch.tensor(rng.random(n) < p_valid)
    return torch.zeros((n, 16)), bbox, valid


def _assert_same_sets(got, want, tag=""):
    """Two Bins (either may be a window of a shared table): per tile the
    same ids, ascending."""
    a, b = _port_sets(got), _port_sets(want)
    assert len(a) == len(b), tag
    for t, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} tile {t}")
        assert np.all(np.diff(x) > 0), f"{tag} tile {t}: ids must ascend"


@pytest.mark.parametrize("h,w,n_bands,offsets", [
    (128, 96, 8, (0, 0)),      # bands of one tile row
    (136, 96, 8, (0, 0)),      # 17 rows: a full and a one-row tile row
    (90, 50, 3, (0, 0)),       # 30 rows, ragged width
    (96, 64, 4, (40, 16)),     # a frame that is itself a shard at an offset
    (64, 64, 1, (0, 0)),       # one band: the plain grid
])
def test_banded_grid_equals_per_band_bins(h, w, n_bands, offsets):
    """bin_triangles(row_bands=N)'s banded grid: band b's window
    (band_bins) holds per tile what bin_triangles holds for band b alone,
    over the shared tri_ids with absolute offsets; bin_bands gives the same
    three ways."""
    y_off, x_off = offsets
    rng = np.random.default_rng(h * 1000 + w + n_bands)
    coef, bbox, valid = _random_setup(rng, 700, h + y_off + 20, w + x_off + 20)
    table = pbin.bin_triangles(coef, bbox, valid, h, w, y_off, x_off, 16, 16,
                               n_bands)
    band_h = h // n_bands
    per_band_tiles = -(-band_h // 16) * -(-w // 16)
    assert table.tile_start.shape == (n_bands * per_band_tiles + 1,)
    assert int(table.tile_start[0]) == 0
    assert int(table.tile_start[-1]) == table.tri_ids.shape[0] > 0
    ways = {
        "shared": pbin.bin_bands(coef, bbox, valid, h, w, n_bands, y_off,
                                 x_off),
        "per band": pbin.bin_bands(coef, bbox, valid, h, w, n_bands, y_off,
                                   x_off, shared=False),
        "distributed": pbin.bin_bands(coef, bbox, valid, h, w, n_bands,
                                      y_off, x_off, distributed=True),
    }
    n_pairs = 0
    for b in range(n_bands):
        want = pbin.bin_triangles(coef, bbox, valid, band_h, w,
                                  y_off + b * band_h, x_off, 16, 16)
        window = pbin.band_bins(table, b, n_bands)
        assert window.tri_ids is table.tri_ids  # a window, not a copy
        assert window.tile_start.shape == want.tile_start.shape
        assert int(window.tile_start[0]) == n_pairs  # absolute offsets
        _assert_same_sets(window, want, f"band {b}")
        np.testing.assert_array_equal(pbin.window_ids(window).numpy(),
                                      want.tri_ids.numpy())
        for tag, bands in ways.items():
            _assert_same_sets(bands[b], want, f"{tag} band {b}")
        n_pairs += want.tri_ids.shape[0]
    assert n_pairs == table.tri_ids.shape[0]
    with pytest.raises(ValueError, match="does not cut"):
        pbin.band_bins(table, n_bands, n_bands)


def test_banded_grid_needs_a_height_the_bands_divide():
    coef, bbox, valid = _random_setup(np.random.default_rng(1), 10, 100, 64)
    with pytest.raises(ValueError, match="must divide"):
        pbin.bin_triangles(coef, bbox, valid, 100, 64, row_bands=8)
    with pytest.raises(ValueError, match="must divide"):
        pbin.bin_bands(coef, bbox, valid, 100, 64, 8, shared=False)


@pytest.mark.parametrize("n_bands,n_tris", [(1, 50), (2, 301), (8, 1003),
                                            (8, 5), (3, 0)])
def test_distributed_kept_pairs_equal_the_shared_table(n_bands, n_tris):
    """Distributed binning against the shared table, per tile, ids
    ascending: N in {1, 2, 8}, T not divisible by N (and T < N: sources with
    no triangle), an empty scene, and a band no triangle touches (band 1 of
    every frame here is kept empty)."""
    h, w = 24 * n_bands, 80
    rng = np.random.default_rng(n_bands * 7 + n_tris)
    coef, bbox, valid = _random_setup(rng, n_tris, h, w)
    if n_bands > 1:
        touches = (bbox[:, 3] >= 24) & (bbox[:, 1] < 48)
        valid = valid & ~touches
    table = pbin.bin_triangles(coef, bbox, valid, h, w, 0, 0, 16, 16, n_bands)
    got = pbin.bin_triangles_distributed([bbox] * n_bands, [valid] * n_bands,
                                         h, w, n_bands)
    assert len(got) == n_bands
    total = 0
    for b, bins in enumerate(got):
        assert int(bins.tile_start[0]) == 0 and int(bins.overflow) == 0
        _assert_same_sets(bins, pbin.band_bins(table, b, n_bands),
                          f"band {b}")
        total += bins.tri_ids.shape[0]
    assert total == table.tri_ids.shape[0]
    if n_bands > 1:
        assert got[1].tri_ids.shape[0] == 0
    with pytest.raises(ValueError, match="one bbox/valid replica per band"):
        pbin.bin_triangles_distributed([bbox], [valid], h, w, n_bands + 1)


def test_exchange_band_buckets_is_an_all_to_all():
    """out[dst] = every source's bucket for dst, in source order, on dst's
    device; a bucket already there is not copied."""
    n = 3
    buckets = [[torch.arange(s * 10 + d, s * 10 + d + (s + d) % 3)
                for d in range(n)] for s in range(n)]
    out = pbin.exchange_band_buckets(buckets, [CPU] * n)
    for d in range(n):
        want = torch.cat([buckets[s][d] for s in range(n)])
        assert torch.equal(out[d], want) and out[d].device == CPU
    moved = pbin.exchange_band_buckets([[torch.arange(4)]],
                                       [torch.device("meta")])
    assert moved[0].device.type == "meta" and moved[0].shape == (4,)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_three_ways_agree_on_random_bboxes(data):
    """Hypothesis: any frame size, band count, tile and bboxes (frame
    coordinates, possibly outside the shard): the three ways give the same
    per-tile sets, and each equals a direct enumeration over the banded
    grid."""
    n_bands = data.draw(st.integers(1, 5))
    band_h = data.draw(st.integers(1, 40))
    w = data.draw(st.integers(1, 70))
    th, tw = data.draw(st.sampled_from([(16, 16), (8, 32), (5, 3)]))
    y_off = data.draw(st.integers(0, 30))
    x_off = data.draw(st.integers(0, 30))
    h = band_h * n_bands
    boxes = data.draw(st.lists(st.tuples(
        st.integers(0, w + x_off + 10), st.integers(0, h + y_off + 10),
        st.integers(0, 30), st.integers(0, 3 * band_h), st.booleans()),
        max_size=30))
    bbox = torch.tensor([[x, y, x + dx, y + dy] for x, y, dx, dy, _ in boxes],
                        dtype=torch.int32).reshape(-1, 4)
    valid = torch.tensor([v for *_, v in boxes], dtype=torch.bool)
    coef = torch.zeros((len(boxes), 16))
    args = (coef, bbox, valid, h, w, n_bands, y_off, x_off, th, tw)
    shared = pbin.bin_bands(*args)
    per_band = pbin.bin_bands(*args, shared=False)
    dist = pbin.bin_bands(*args, distributed=True)
    n_tyb, n_tx = -(-band_h // th), -(-w // tw)
    for b in range(n_bands):
        want = [[] for _ in range(n_tyb * n_tx)]
        for i, (x, y, dx, dy, ok) in enumerate(boxes):
            # the band's pixels that the bbox overlaps, in band coordinates
            bx0, bx1 = max(x - x_off, 0), min(x + dx - x_off, w - 1)
            by0 = max(y - y_off - b * band_h, 0)
            by1 = min(y + dy - y_off - b * band_h, band_h - 1)
            if not ok or bx0 > bx1 or by0 > by1:
                continue
            for ty in range(by0 // th, by1 // th + 1):
                for tx in range(bx0 // tw, bx1 // tw + 1):
                    want[ty * n_tx + tx].append(i)
        for tag, bands in (("shared", shared), ("per band", per_band),
                           ("distributed", dist)):
            sets = _port_sets(bands[b])
            assert len(sets) == len(want)
            for t, (g, wnt) in enumerate(zip(sets, want)):
                assert g.tolist() == wnt, (tag, b, t)
