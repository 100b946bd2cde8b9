"""Scene runner CLI: renders any BASELINE config, the demo scene or an OBJ
file to PNG/NPY. Port of the reference's `tools/cli.py`.

Examples:
  python -m dtrenderer_tpu_torch.tools.cli --scene 3 --frames 5 --out c3.png
  python -m dtrenderer_tpu_torch.tools.cli --scene 4 --backend pallas --w 1920 --h 1080
  python -m dtrenderer_tpu_torch.tools.cli --scene data/head.obj --cpu --w 160 --h 120

Renders on the first CUDA device; --cpu renders on the CPU instead. Without
a card and without --cpu it exits with an error. --rows/--cols above 1 (the
reference's split of a frame into bands over several devices) raise
NotImplementedError: ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from dtrenderer_tpu_torch.models import primitives, scenes
from dtrenderer_tpu_torch.ops import fb as fblib
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.pipeline import draw_mesh
from dtrenderer_tpu_torch.ops.shading import make_light
from dtrenderer_tpu_torch.platform import write_png
from dtrenderer_tpu_torch.tools import demo, pick_device
from dtrenderer_tpu_torch.utils import math3d as m3
from dtrenderer_tpu_torch.utils.color import pack_srgb_u8


def obj_scene(path: str, w: int, h: int, backend: str, device):
    """(name, n_tris, frame(color, depth, t)) for an OBJ file, auto-framed:
    centred and scaled to a unit-ish box, Gouraud + bilinear gradient."""
    from dtrenderer_tpu_torch.assets.obj import load_obj

    mesh = load_obj(path, device=device)
    v = mesh.verts.cpu().numpy()
    center = (v.max(0) + v.min(0)) / 2
    radius = float(np.linalg.norm(v - center, axis=1).max())
    proj = m3.perspective(np.pi / 3, w / h, 0.05 * radius, 100.0 * radius,
                          device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    tex = primitives.gradient_texture(64, device=device)

    def frame(color, depth, t):
        fb = fblib.clear(Framebuffer(color, depth), [0.05, 0.05, 0.08, 1.0])
        mdl = m3.mat4mul(
            m3.mat4mul(m3.translate((0, 0, -2.8 * radius), device=device),
                       m3.rotate_y(t, device=device)),
            m3.translate(-center, device=device))
        fb = draw_mesh(fb, mesh, mdl, proj, texture=tex, light=light,
                       shading="gouraud", sampling_mode="bilinear",
                       backend=backend)
        return fb.color, fb.depth

    return os.path.basename(path), mesh.num_tris, frame


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
                    help="row bands over devices (not ported: raises above 1)")
    ap.add_argument("--cols", type=int, default=1,
                    help="column bands over devices (not ported: raises above 1)")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("--tris", type=int, default=1_000_000,
                    help="triangle count for scene 5")
    ap.add_argument("--save-npy", action="store_true",
                    help="also dump the raw f32 framebuffer")
    args = ap.parse_args(argv)

    if args.rows > 1 or args.cols > 1:
        raise NotImplementedError(
            "--rows/--cols: the band split of a frame over several devices "
            "(parallel/shard.py) is not ported yet, ROADMAP.md queue 1 "
            "item 12")
    dev = pick_device(args.cpu)
    print(f"device: {dev}", file=sys.stderr)

    if args.scene == "demo":
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

    if args.scene.endswith(".obj"):
        w, h = args.w or 800, args.h or 600
        name, n_tris, frame = obj_scene(args.scene, w, h, args.backend, dev)
    else:
        n = int(args.scene)
        kw = {}
        if args.w:
            kw["width"] = args.w
        if args.h:
            kw["height"] = args.h
        if n == 5:
            kw["n_tris"] = args.tris
        spec = scenes.ALL_CONFIGS[n](backend=args.backend, device=dev, **kw)
        name, n_tris, frame = spec.name, spec.n_tris, spec.frame
        w, h = spec.width, spec.height

    print(f"scene {name}: {w}x{h}, {n_tris} tris, backend={args.backend}",
          file=sys.stderr)

    # Each frame renders fresh from the cleared framebuffer (frame() clears).
    fb0 = fblib.create(h, w, dev)
    color = fb0.color
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
