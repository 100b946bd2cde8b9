"""Scene runner CLI: renders any BASELINE config, the demo scene or an OBJ
file to PNG/NPY. Port of the reference's `tools/cli.py`.

Examples:
  python -m dtrenderer_tpu_torch.tools.cli --scene 3 --frames 5 --out c3.png
  python -m dtrenderer_tpu_torch.tools.cli --scene 4 --backend pallas --w 1920 --h 1080
  python -m dtrenderer_tpu_torch.tools.cli --scene data/head.obj --cpu --w 160 --h 120
  python -m dtrenderer_tpu_torch.tools.cli --scene 4 --rows 4 --cols 2

Renders on the first CUDA device; --cpu renders on the CPU instead. Without
a card and without --cpu it exits with an error. --rows/--cols above 1 cut
the frame into rows x cols tiles over every CUDA device (cycled; all on the
CPU with --cpu) and render it through parallel.shard.render_frames_sharded;
the image is that of the unbanded render, bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from dtrenderer_tpu_torch.models import primitives, scenes
from dtrenderer_tpu_torch.ops import fb as fblib
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.pipeline import audit_bands, draw_mesh
from dtrenderer_tpu_torch.parallel import shard
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.platform import write_png
from dtrenderer_tpu_torch.tools import demo, pick_device
from dtrenderer_tpu_torch.utils import math3d as m3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8


def obj_scene(path: str, w: int, h: int, backend: str, device):
    """(name, n_tris, frame(color, depth, t, <band arguments>)) for an OBJ
    file, auto-framed: centred and scaled to a unit-ish box, Gouraud +
    bilinear gradient."""
    from dtrenderer_tpu_torch.assets.obj import load_obj

    mesh = load_obj(path, device=device)
    v = mesh.verts.cpu().numpy()
    center = (v.max(0) + v.min(0)) / 2
    radius = float(np.linalg.norm(v - center, axis=1).max())
    proj = m3.perspective(np.pi / 3, w / h, 0.05 * radius, 100.0 * radius,
                          device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    tex = primitives.gradient_texture(64, device=device)

    def frame(color, depth, t, y_offset=0, frame_height=None,
              frame_width=None, x_offset=0):
        fb = fblib.clear(Framebuffer(color, depth), [0.05, 0.05, 0.08, 1.0])
        mdl = m3.mat4mul(
            m3.mat4mul(m3.translate((0, 0, -2.8 * radius), device=device),
                       m3.rotate_y(t, device=device)),
            m3.translate(-center, device=device))
        fb = draw_mesh(fb, mesh, mdl, proj, texture=tex, light=light,
                       shading="gouraud", sampling_mode="bilinear",
                       backend=backend, y_offset=y_offset, x_offset=x_offset,
                       frame_height=frame_height, frame_width=frame_width)
        return fb.color, fb.depth

    return os.path.basename(path), mesh.num_tris, frame


def make_scene(args, dev):
    """(name, n_tris, width, height, frame, submission or None) of
    --scene on one device."""
    if args.scene.endswith(".obj"):
        w, h = args.w or 800, args.h or 600
        name, n_tris, frame = obj_scene(args.scene, w, h, args.backend, dev)
        return name, n_tris, w, h, frame, None
    n = int(args.scene)
    kw = {}
    if args.w:
        kw["width"] = args.w
    if args.h:
        kw["height"] = args.h
    if n == 5:
        kw["n_tris"] = args.tris
    spec = scenes.ALL_CONFIGS[n](backend=args.backend, device=dev, **kw)
    return (spec.name, spec.n_tris, spec.width, spec.height, spec.frame,
            spec.submission)


def render_sharded(args, make, w: int, h: int):
    """--frames frames of the scene over a 1 x rows x cols mesh, each from
    the cleared framebuffer; returns the last frame's colour plane on the
    mesh's first device. make(device) -> the scene's frame function there
    (one scene per distinct device: a band renders where its tile lies)."""
    devices = [torch.device("cpu")] if args.cpu else None
    dmesh = shard.make_mesh(frames=1, rows=max(args.rows, 1), cols=args.cols,
                            devices=devices)
    frame_on = {d: make(d) for d in dmesh.distinct()}

    def band_fn(band_fb, t, y0, fh, fw, x0):
        c, d = frame_on[band_fb.depth.device](
            band_fb.color, band_fb.depth, t, y_offset=y0, frame_height=fh,
            frame_width=fw, x_offset=x0)
        return Framebuffer(c, d)

    fbs = shard.create_sharded_fb(h, w, dmesh, batch=1)
    for i in range(args.frames):
        t0 = time.perf_counter()
        out = shard.render_frames_sharded(
            band_fn, fbs, dmesh, [0.6 + 0.05 * i])
        color = shard.gather_fb(out).color[0]
        color_np = color.cpu().numpy()
        print(f"frame {i}: {(time.perf_counter() - t0) * 1000:.1f} ms over "
              f"{dmesh.shape['rows']}x{dmesh.shape['cols']} tiles on "
              f"{len(dmesh.distinct())} device(s) (incl. host fetch)",
              file=sys.stderr)
    return color, color_np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scene", default="demo",
                    help="demo | 1..5 (BASELINE configs) | path/to/mesh.obj")
    ap.add_argument("--w", type=int, default=None)
    ap.add_argument("--h", type=int, default=None)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--backend", default="fused", choices=["ref", "pallas", "fused"])
    ap.add_argument("--rows", type=int, default=0,
                    help="row bands over the devices (parallel/shard.py)")
    ap.add_argument("--cols", type=int, default=1,
                    help="column bands over the devices")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("--tris", type=int, default=1_000_000,
                    help="triangle count for scene 5")
    ap.add_argument("--save-npy", action="store_true",
                    help="also dump the raw f32 framebuffer")
    args = ap.parse_args(argv)

    dev = pick_device(args.cpu)
    print(f"device: {dev}", file=sys.stderr)

    if args.scene == "demo":
        if args.rows > 1 or args.cols > 1:
            raise SystemExit("--rows/--cols split the numbered scenes and "
                             "OBJ files; the demo scene draws 2D verbs over "
                             "the whole frame")
        demo_args = ["--out", args.out, "--frames", str(args.frames),
                     "--backend", args.backend]
        if args.w:
            demo_args += ["--w", str(args.w)]
        if args.h:
            demo_args += ["--h", str(args.h)]
        if args.cpu:
            demo_args.append("--cpu")
        demo.main(demo_args)
        return

    name, n_tris, w, h, frame, submission = make_scene(args, dev)
    print(f"scene {name}: {w}x{h}, {n_tris} tris, backend={args.backend}",
          file=sys.stderr)

    if args.rows > 1 or args.cols > 1:
        if submission is not None and args.rows > 1:
            sub = submission(0.6)
            print("audit_bands:", audit_bands(
                sub.view_proj, sub.draws, h, w, args.rows, light=sub.light,
                near_clip=sub.near_clip), file=sys.stderr)
        color, color_np = render_sharded(
            args, lambda d: frame if d == dev else make_scene(args, d)[4],
            w, h)
    else:
        # Each frame renders fresh from the cleared framebuffer (frame()
        # clears).
        fb0 = fblib.create(h, w, dev)
        for i in range(args.frames):
            t0 = time.perf_counter()
            color, _ = frame(fb0.color, fb0.depth, 0.6 + 0.05 * i)
            color_np = color.cpu().numpy()
            print(f"frame {i}: {(time.perf_counter() - t0) * 1000:.1f} ms "
                  f"(incl. host fetch)", file=sys.stderr)

    write_png(args.out, pack_srgb_u8(color).cpu().numpy())
    print(f"wrote {args.out}")
    if args.save_npy:
        np.save(args.out + ".npy", color_np)
        print(f"wrote {args.out}.npy")


if __name__ == "__main__":
    main()
