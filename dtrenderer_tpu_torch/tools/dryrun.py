"""Multi-device dry run of the band split: every sharded path at a small
size, each held bit-equal to the single-device render. Port of the
reference's `__graft_entry__.dryrun_multichip`.

    python -m dtrenderer_tpu_torch.tools.dryrun --devices 8 [--cpu]

--devices is the number of mesh cells. The cells are laid over every CUDA
device, cycled (on one card all of them are that card); --cpu lays them over
the CPU instead. Without a card and without --cpu it exits with an error.
Prints one "dryrun_multichip ok" line per scene:

  1. a frames x rows mesh: a batch of cube frames through
     render_frames_sharded with a band function of five parameters;
  2. a 10,000-triangle soup over N row bands, each band binning for itself,
     with the audit_bands report of the scene;
  3. the same through one shared cross-band table per device;
  4. the same through the distributed binning and its band exchange;
  5. the soup as an ordered translucent draw over N bands;
  6. the soup over a rows x cols mesh (N even).

The reference's shard_budget, dense/flat and slab-window scenes have no
counterpart: the port's bins have no capacity to audit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.ops import fb as fblib
from dtrenderer_tpu_torch.ops.pipeline import (
    DrawSpec, audit_bands, draw_mesh, draw_mesh_ordered,
)
from dtrenderer_tpu_torch.parallel import shard
from dtrenderer_tpu_torch.tools import pick_device
from dtrenderer_tpu_torch.utils import math3d as m3

BAND_H = 24  # not a multiple of the kernels' 16-row tile: ragged bands


def _equal(tag, got, want):
    """Colour and depth bit-equal (a float compare would pass -0 == 0 and
    fail on NaN)."""
    for name in ("color", "depth"):
        a = getattr(got, name).cpu().view(torch.int32)
        b = getattr(want, name).cpu().view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the "
                                 f"single-device render at "
                                 f"{int((a != b).sum())} elements")


def dryrun_multichip(n_cells: int, devices=None) -> None:
    """Run every scene over meshes of n_cells cells of `devices` (None:
    every CUDA device, cycled) and raise unless each sharded render equals
    the single-device render on the mesh's first device, bit for bit."""
    frames = 2 if n_cells % 2 == 0 and n_cells >= 2 else 1
    rows = n_cells // frames
    dmesh = shard.make_mesh(frames=frames, rows=rows, devices=devices)
    dev = dmesh.device(0, 0, 0)
    n_dev = len(set(dmesh.devices.reshape(-1).tolist()))

    # ---- scene 1: frames x rows, a batch of cube frames ----
    h, w = 8 * rows, 128
    cube = {d: primitives.cube(device=d) for d in dmesh.devices.flat}
    tex = {d: primitives.checkerboard(8, 2, device=d) for d in cube}
    proj = {d: m3.perspective(np.pi / 3, w / h, 0.1, 100.0, device=d)
            for d in cube}

    def band_fn(band_fb, angle, y0, fh, fw):
        d = band_fb.depth.device
        mdl = m3.model_matrix((0, 0, -4.0), m3.rotate_y(angle, device=d),
                              device=d)
        return draw_mesh(band_fb, cube[d], mdl, proj[d], texture=tex[d],
                         shading="gouraud", frame_height=fh, frame_width=fw,
                         y_offset=y0, backend="fused")

    angles = np.linspace(0.2, 1.0, frames).astype(np.float32)
    out = shard.render_frames_sharded(
        band_fn, shard.create_sharded_fb(h, w, dmesh, batch=frames), dmesh,
        angles)
    got = shard.gather_fb(out, dev)
    for i in range(frames):
        want = band_fn(fblib.create(h, w, dev), torch.as_tensor(angles[i]),
                       0, h, w)
        _equal(f"frame {i}", fblib.Framebuffer(got.color[i], got.depth[i]),
               want)
    print(f"dryrun_multichip ok: mesh=({frames}x{rows}) frame={h}x{w} "
          f"batch={frames} cells={n_cells} devices={n_dev} "
          f"sharded==single-device: bit-exact")

    # ---- scenes 2-4: the soup over N bands, three ways of binning ----
    rows2 = n_cells
    dmesh2 = shard.make_mesh(frames=1, rows=rows2, devices=devices)
    h2, w2 = BAND_H * rows2, 128
    n_soup = 10_000
    soup = primitives.random_triangle_soup(n_soup, rng_seed=7, extent=1.4,
                                           device=dev)
    proj2 = m3.perspective(np.pi / 3, w2 / h2, 0.1, 100.0, device=dev)
    mdl2 = m3.model_matrix((0, 0, -2.8), m3.rotate_y(0.2, device=dev),
                           device=dev)
    kw = dict(shading="gouraud", backend="fused", near_clip=False)
    single = draw_mesh(fblib.create(h2, w2, dev), soup, mdl2, proj2, **kw)

    def run_sharded(mesh, opts):
        out, counters = shard.draw_mesh_sharded(
            shard.create_sharded_fb(h2, w2, mesh), soup, mdl2, proj2, mesh,
            raster_opts=opts, return_counters=True, **kw)
        if int(counters.bin_overflow) != 0:
            raise AssertionError(f"bin overflow {int(counters.bin_overflow)}")
        return shard.gather_fb(out, dev)

    ways = [
        ("per-band binning", None),
        ("shared cross-band binning (one table, per-band windows)",
         dict(row_bands=rows2)),
        ("DISTRIBUTED cross-band binning (1/N pair emission + band "
         "exchange)", dict(row_bands=rows2, band_distributed=True)),
    ]
    for tag, opts in ways:
        _equal(tag, run_sharded(dmesh2, opts), single)
        rep = audit_bands(proj2, [DrawSpec(soup, mdl2)], h2, w2, rows2,
                          near_clip=False, raster_opts=opts)
        if not rep["ok"]:
            raise AssertionError(f"audit_bands flagged the soup: {rep}")
        print(f"dryrun_multichip ok: soup {n_soup} tris over {rows2} bands "
              f"of {BAND_H} rows, {tag}, bit-exact vs single-device, "
              f"overflow=0, audit_bands shared={rep['shared']} band_tris="
              f"{rep['band_tris']} band_pairs={rep['band_pairs']}")

    # ---- scene 5: ORDERED (translucent) draw over N bands ----
    okw = dict(color=(0.8, 0.5, 0.9, 0.5), shading="gouraud", engine="tile",
               near_clip=False)
    out5 = shard.draw_mesh_ordered_sharded(
        shard.create_sharded_fb(h2, w2, dmesh2), soup, mdl2, proj2, dmesh2,
        **okw)
    single5 = draw_mesh_ordered(fblib.create(h2, w2, dev), soup, mdl2, proj2,
                                **okw)
    _equal("ordered", shard.gather_fb(out5, dev), single5)
    print("dryrun_multichip ok: ordered translucent draw sharded over rows, "
          "bit-exact vs single-device, overflow=0")

    # ---- scene 6: 2D (rows x cols) framebuffer decomposition ----
    if n_cells % 2 == 0:
        dmesh3 = shard.make_mesh(frames=1, rows=n_cells // 2, cols=2,
                                 devices=devices)
        _equal("rows x cols", run_sharded(dmesh3, None), single)
        print(f"dryrun_multichip ok: 2D mesh ({n_cells // 2}x2 rows x cols) "
              f"bit-exact vs single-device")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--devices", type=int, default=8,
                    help="number of mesh cells (cycled over the devices)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)  # exits without a card unless --cpu
    dryrun_multichip(args.devices, [dev] if args.cpu else None)


if __name__ == "__main__":
    main()
