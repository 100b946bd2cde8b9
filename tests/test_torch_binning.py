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
