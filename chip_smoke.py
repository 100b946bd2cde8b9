#!/usr/bin/env python3
"""Hardware smoke gate of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, on one card
    python3 chip_smoke.py --bin-against DIR  # phases 1, 2 and the
                                     # binning of the checkout at DIR
                                     # against this tree's, in turns
    python3 chip_smoke.py --bands    # phases 1, 2 and the band split over
                                     # every card (band_paths and
                                     # band_graph_check)
    python3 chip_smoke.py --verbs-against DIR  # phases 1, 2 and the API
                                     # frame's verbs of the checkout at DIR
                                     # and of this tree, in turns, each in a
                                     # process of its own (verb_times)

Run from the root of a checkout. Phases, each of which raises on failure:

  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the seven kernel sources (csrc/render_fused.cu = K1,
     csrc/raster_visibility.cu = K2, csrc/render_ordered.cu = K3,
     csrc/vertex_pass.cu = VP, the vertex stage, csrc/binning.cu = BN, the
     binning, csrc/shade_deferred.cu = DS, the deferred shading,
     csrc/draw2d.cu = D2, the 2D verbs), one nvcc per source, all started
     together; seconds, registers and spills;
  3. kernel vs plain twin at the main paths' shapes, both timed with CUDA
     events (plain, kernel, kernel, plain):
       K1 at config 4 (1920x1080) and config 5 (3840x2160, 1,000,000
         triangles, t = 0.5): z bit-equal, src max |diff| <= 1e-6, packed u8
         within +-1 with zero outliers;
       K2 at config 5 and at config 4's four 1080p draws: z bit-equal, tri
         equal at every pixel;
       K3 at the translucent sphere (uv_sphere(50, 52), 5,096 triangles,
         1920x1080 over a cleared framebuffer): depth bit-equal, colour max
         |diff| <= 1e-6, packed u8 within +-1 with zero outliers;
       DS at config 5 on "pallas" (K2's z and tri) and at config 4's four
         1080p draws on "pallas" (textured, Phong, bilinear), each draw
         into the framebuffer of the draws before it: depth bit-equal,
         colour max |diff| 0 against shade_deferred_plain; 20 wrapper
         calls against the plain twin and the launch loop, beside the
         bound by bytes;
       K1 merge epilogue vs plain: render_fused(..., fb=...), the draw
         call's path, against render_fused_plain(..., fb=...), the torch
         merge, over a seeded framebuffer (depth +inf, ties, uniform,
         NaN) at config 5, config 4 and config 5 in 8 row bands of the
         shared table writing one pair of planes: depth bit-equal, colour
         max |diff| 0 (NaN at the same places), winners counted equal,
         the framebuffer unwritten; at config 5 and 4 the merging wrapper
         against the twin, K1's launch loop with and without the merge,
         the torch merge alone, the bound with the framebuffer's bytes;
     each kernel is also timed, twice, as 200 back-to-back launches of its
     ctypes entry on preallocated outputs between two CUDA events
     ("launch loop"): the 20-70 us kernels (K3, K1 and K2 at config 4) are
     then paced by the card and not by the Python wrapper;
     with K1's and K2's share of surviving coarse-stage bits per scene (of
     every binned pair's 8 sub-block bits, those the edge functions leave
     set: the share of per-warp edge tests the kernels still run); then K1
     and K2 bit-equal to their twins at shapes the scenes do not reach: a
     tile of more than 512 triangles, grids of shared edges through pixel
     centres and along sub-block borders, each as a whole frame and as
     ragged shards at non-zero offsets (K1 also with its merge);
       D2 at 1920x1080 (draw2d_kernel_vs_plain): every case of
         models/draw2d_cases.py (every verb kind, windows partly and wholly
         off the frame, zero sizes, non-finite and far values, both text
         layouts at scale 1 and 2, strings longer than a launch) through
         draw2d.draw against draw_plain, and every render_triangle case
         against the CPU path: bit-equal, NaN at the same places, inputs
         unwritten, one launch a verb; the API frame's ten D2 launches
         timed (loop of the prepared entry calls, wrapper, plain twin)
         against the bound by bytes; setup_host against the
         card's setup; the API frame's 2D verbs, text and render_triangle
         under torch.cuda.set_sync_debug_mode("error");
  4. main paths through the public entry points, each with every kernel's
     launch count set to 0 just before and read just after (VP: at least
     once per pack_draws call on "fused" and "tile", counted by
     vertex_batch.run_pass and by every replay of a graph that captured it,
     and once per draw staged on "pallas", "ref" and "scan" (an eager
     vertex_batch.pack); BN: once per binning.bin_triangles call, i.e. per
     K1, K2 or K3 launch that bins for itself, once per shared table, never
     for the distributed exchange; DS: once per pipeline.shade_deferred
     call, i.e. per draw on "pallas" and "ref" and per render_triangle;
     D2: once per 2D verb, string of up to 256 glyphs and
     render_triangle):
       config 4 (draw_meshes) 3 frames and config 5 (draw_mesh "fused") 2
         frames: one K1 launch per frame;
       config 5 on backend "pallas", 2 frames: one VP, one K2 and one DS
         launch per frame;
       config 4 on backend "pallas", 2 frames: four VP, four K2 and four DS
         launches per frame;
       the translucent sphere through draw_mesh_ordered, 3 frames: one K3
         launch per frame;
       config 4's draws at 1080p with the first sphere translucent
         (alpha 0.6) between the opaque draws, one draw_meshes, 2 frames:
         one K1 launch per opaque run (2) and one K3 launch per frame;
       the API frame, 1920x1080, 3 frames through platform.run_app with an
         InputScript, built from api verbs only: tools.demo.demo_frame on
         "fused" (clear, one render_meshes = one K1 launch, two alpha
         rectangles, a line, a circle, a rotated scaled bilinear blit),
         render_mesh_ordered of the translucent sphere (one K3 launch), a
         textured render_triangle, the DebugHud with the frame's counters,
         a proportional footer, finish_frame: K1 3, K2 0, K3 3, DS 3, D2
         30 (ten 2D launches a frame); then one demo_frame on "pallas": VP
         3, K2 3, DS 3, D2 5. The last frame is written with
         present_png, decoded again natively and must equal the packed
         frame byte for byte;
     ms/frame, shaded Mpix/s and Mtris/s;
  5. band paths (parallel/shard.py), meshes 1 x 8 x 1 and 1 x 4 x 2 over
     this machine's cards, cycled (one card: every cell is cuda:0), each
     path counted as in 4 and held bit-equal (z/depth and colour) to its
     single-launch frame:
       config 5 (3840x2160, 1,000,000 triangles) in 8 row bands of 270
         rows through draw_mesh_sharded on "fused", binned per band,
         through the shared table and through the distributed exchange, 2
         frames each: 8 K1 launches a frame; the same three ways through
         draw_mesh(raster_opts row_bands=8) on the whole framebuffer, the
         shared one also as benchlib.device_time over 5 calls;
       config 5 on "pallas", 8 bands, 2 frames: 8 K2 launches a frame and
         one VP launch per card of the mesh;
       the three ways' binning alone (ms) and their kept pairs, equal per
         tile with ids ascending; K1's eight band launches back to back
         against the one whole-frame launch (CUDA events);
       config 4 (1920x1080) through render_frames_sharded with the scene's
         band arguments on 4 x 2 tiles of 270x960, 2 frames: 8 K1 launches
         a frame;
       the translucent sphere, 1080p, 8 bands of 135 rows through
         draw_mesh_ordered_sharded, 2 frames: 8 K3 launches a frame;
       tools.dryrun over 8 cells, in-process;
  6. vertex kernel vs plain twin: vertex_batch.run_pass (VP) against
     run_pass_plain on the same plan and frame vector, every DrawBatch
     field bit for bit, invalid rows included (NaN at the same places), for
     the bench cells' runs (fill, config 4, soup, config 5, the translucent
     sphere, the API frame's render_meshes run), config 4 with the
     translucent sphere between its opaque runs, config 4 with near clip off
     and culling off, every case of models/edge_cases.py and the shapes of
     models/stress.py in the four shading modes; the cells' runs timed (a
     loop of 200 launches of the ctypes entry; run_pass against the plain
     pass, plain, kernel, kernel, plain) against the bound by bytes;
     vertex stage graph (ops/vertex_graph.py), with VP inside the graph:
     for the fill scene, config
     4, the soup, config 5, the translucent sphere and the API frame's
     render_meshes run, pipeline.pack_draws replayed from its CUDA graph
     bit-equal to the eager pass (vertex_batch.pack) at t = 0.5 (first
     sighting eager, second captured), 0.3 and 0.7, with each key's eager
     runs, captures, replays and graph pool printed; the stage eager
     against replay: the ATen ops the host dispatches a call, and its time
     on the host clock and with CUDA events, every timed replay counted as
     one; config 4's head mesh and texture changed in
     place and read by the next replay; config 4 as [head, cube,
     translucent sphere, head, cube] in one draw_meshes (two opaque runs
     of one key) bit-equal to the eager frame; config 5 on a 1 x 8 x 1
     mesh (cuda:0 on one card, every card cycled on more), per band and
     shared, bit-equal to the eager single launch at four times, with each
     card's keys seen once and captured;
     then many keys: 16 draw_mesh calls a frame on distinct meshes (16
     keys), once with the same meshes every frame (all replays) and once
     with fresh copies every call (all eager), each bit-equal to and timed
     against the per-draw stage the batched pass replaced;
     then steady device time: each bench cell (bench_torch/cells.py)
     through the bench's own traced window (bench_torch/run.py trace_cell:
     5 warm-up frames, then 5 traced frames with no eager pass and no
     capture, replaying where the cell's route does): device busy ms a
     frame and busy share;
     binning kernel vs plain twin: binning.bin_triangles (BN) against
     bin_triangles_plain at every main path's inputs (config 5, config 5 in
     8 bands over the shared table, the soup, the fill scene, config 4, the
     translucent sphere, the API frame's render_meshes run), the stress
     shapes in their windows and the edge cases: tile_start, tri_ids and
     overflow bit for bit; pairs and tiles per scene; the main paths'
     inputs timed (a loop of 200 device passes without the host read, the
     same passes captured once in a CUDA graph and replayed 200 times, the
     call against the plain path: plain, kernel, kernel, plain) against the
     bound by bytes, with the device operations of a call and their
     microseconds (torch.profiler) and the host synchronisations a call
     counted under torch.cuda.set_sync_debug_mode("warn"): 1 (the plain
     path's beside it);
  7. stage breakdown of one frame per path (vertex stage + packing,
     binning, kernel, merge or deferred shading; on "fused" K1 and the
     torch merge apart, as the bench splits them, and K1 with the merge
     beside them; on "pallas" the vertex stage is stage_draw_mesh, with
     prepare_draw timed beside it), after the counted windows; config 5's
     device operations a steady frame with the merge in K1 and with the
     torch merge it replaced; and the API frame's verbs one by one (host
     ms to a synchronise and the call's own host ms, best of three; device
     ms and device operations of a call, torch.profiler; ATen operations;
     host synchronisations); then staging vs prepare_draw: the vertex stage of "pallas",
     "ref" and "scan" (one VP launch, no vertex graph sighting) against
     prepare_draw on the card at config 5 ("pallas") and config 4's four
     draws (all three routes): setup.coef, bbox, valid and attrs10
     bit-equal, NaN at the same places, attrs10 read by DS without a copy;
     host ops and ms a frame of the stage, prepare_draw and plan_run;
  8. reference check, small frames on the card against the same frames on
     the CPU: configs 1-3 (160x120) on "ref", "pallas" and "fused", configs
     4 and 5 small on "fused", and a 160x120 translucent sphere through the
     "tile" and "scan" engines: depth bit-equal, u8 within +-1, no outliers;
     then every 2D verb, both text functions with both fonts, a textured
     render_triangle and the HUD, after each verb: the same bar, and depth
     bit-equal to the depth before each 2D verb;
  9. edge cases (models/edge_cases.py: the reference's degenerate inputs,
     NaN / infinite / 1e12 UVs at LUT base 0 and > 0, a vertex at +-1e12
     pixels, a camera in a box, a triangle fan, integer edges), each on the
     card and on the CPU through "fused" (K1), "pallas" (K2), "ref" and the
     "tile" engine (K3), counted as in 4: depth bit-equal, colour NaN at the
     same channels and within 1e-6 elsewhere, u8 within +-1, no outliers;
     each kernel against its plain twin on the card for those inputs, K2's
     ids against the CPU's; math3d.to_i32 on the card = CPU = CUDA cast.
     One line per case.

Prints one JSON line describing the kernels (with each kernel's least time
on the card, its bound), then, as the last line, {"ok": true, "device":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC_TOL = 1e-6
DEVICE = "cuda:0"  # the card the phases run on

# The least time the card could take: the larger
# of bytes moved over the memory rate and operations over the peak rate of
# their type (NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s
# float32 outside the tensor cores, both at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations the kernels must do, counted from FORMULAS.md:
EDGE_OPS = 12      # per (binned triangle, pixel in tile and bbox): 3 x (2 mul
                   # + 2 add); a pixel outside the bbox cannot be covered
BARY_Z_OPS = 8     # per covered fragment: 3 mul barycentrics, 3 mul 2 add z
SHADE_BASE = 46    # interp of 7 channels (5 each), 1 divide, 6 mul, modulate 4
SHADE_NEAREST = 3  # u*tw, 1-v, *th
SHADE_BILINEAR = 45  # fxs/fys 5, fractions 2, +1 2, 12 lerps of 3
SHADE_PHONG = 47   # interp 3x5, 3 mul, norm 5+1+3, light 9, dot 5, max, term 2, 3 mul
BLEND_OPS = 9      # 1 - a, 4 mul, 4 add


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def interleaved_ms(kernel, plain, reps: int):
    """(kernel ms, plain ms, the four readings), timed plain, kernel,
    kernel, plain in one call; each the best of its two batches."""
    p1 = cuda_ms(plain, 1)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, 1)
    return min(k1, k2), min(p1, p2), (p1, k1, k2, p2)


def launch_loop_ms(launch, reps: int = 200):
    """Two readings of `launch` (a kernel's ctypes entry on preallocated
    tensors, nothing else per turn) over `reps` back-to-back launches: the
    host enqueues a turn in a few microseconds, so the card sets the pace."""
    return cuda_ms(launch, reps), cuda_ms(launch, reps)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_pixels(bbox, bins, width) -> int:
    """Pixels whose edge functions these inputs need: over every binned
    (tile, triangle) pair, the tile's pixels inside the triangle's
    (inclusive, frame-clamped) bbox. The bins are a whole frame's at offset
    (0, 0) (a band's window of a shared table is read through
    binning.window_ids, but its tiles would need the band's origin)."""
    import torch

    from dtrenderer_tpu_torch.ops.binning import window_ids

    counts = (bins.tile_start[1:] - bins.tile_start[:-1]).long()
    tile = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    n_tx = -(-width // bins.tile_w)
    ty0 = (tile // n_tx) * bins.tile_h
    tx0 = (tile % n_tx) * bins.tile_w
    bb = bbox[window_ids(bins).long()].long()
    w = (torch.minimum(bb[:, 2], tx0 + bins.tile_w - 1)
         - torch.maximum(bb[:, 0], tx0) + 1).clamp(min=0)
    h = (torch.minimum(bb[:, 3], ty0 + bins.tile_h - 1)
         - torch.maximum(bb[:, 1], ty0) + 1).clamp(min=0)
    return int((w * h).sum())


def surviving_bits(coef, bins, height, width) -> float:
    """Share of the coarse stage's sub-block bits that stay set over every
    binned pair (render_fused.subblock_masks_plain, the plain twin of the
    kernels' coarse stage): the share of per-warp edge tests K1 and K2
    still run."""
    from dtrenderer_tpu_torch.ops import render_fused as rf

    masks = rf.subblock_masks_plain(coef, bins, height, width)
    bits = sum(int(((masks >> s) & 1).sum()) for s in range(rf.SUBS))
    return bits / max(1, rf.SUBS * masks.numel())


def shade_ops(flags):
    """float32 operations to shade one fragment of each triangle flag in
    `flags` (a tensor of payload flags values), summed."""
    import torch

    bil = flags >= 2.0
    phong = torch.fmod(flags, 2.0) > 0
    per = (SHADE_BASE + torch.where(bil, SHADE_BILINEAR, SHADE_NEAREST)
           + torch.where(phong, SHADE_PHONG, 0))
    return int(per.sum())


def compare(tag, z_a, src_a, z_b, src_b):
    """z bit-equal, src within SRC_TOL, packed u8 within +-1 everywhere.
    Returns max |src diff|."""
    import torch

    from dtrenderer_tpu_torch.utils.color import pack_srgb_u8

    z_a, z_b = z_a.cpu(), z_b.cpu()
    if not torch.equal(z_a.view(torch.int32), z_b.view(torch.int32)):
        n = int((z_a.view(torch.int32) != z_b.view(torch.int32)).sum())
        raise AssertionError(f"{tag}: z differs at {n} pixels")
    err = float((src_a.cpu() - src_b.cpu()).abs().max())
    if not err <= SRC_TOL:
        raise AssertionError(f"{tag}: src max |diff| {err} > {SRC_TOL}")
    du8 = (pack_srgb_u8(src_a.cpu()).int() - pack_srgb_u8(src_b.cpu()).int())
    n_out = int((du8.abs() > 1).sum())
    if n_out:
        raise AssertionError(f"{tag}: {n_out} packed u8 channels differ by >1")
    covered = int(torch.isfinite(z_a).sum())
    print(f"{tag}: z bit-equal, src max|diff| {err:.3g}, u8 within +-1 "
          f"(0 outliers), covered px {covered}")
    return err


def bin_batch(batch, height, width):
    from dtrenderer_tpu_torch.ops import binning, render_fused as rf

    return binning.bin_triangles(batch.coef, batch.bbox, batch.valid, height,
                                 width, 0, 0, rf.TILE_H, rf.TILE_W)


def bin_report(tag, batch, bins):
    counts = bins.tile_start[1:] - bins.tile_start[:-1]
    print(f"{tag}: {batch.coef.shape[0]} setup rows, {bins.tri_ids.shape[0]} "
          f"(tile, tri) pairs, max bin {int(counts.max())}")


def pack_submission(spec, t=0.5):
    from dtrenderer_tpu_torch.ops import pipeline

    sub = spec.submission(t)
    return sub, pipeline.pack_draws(sub.draws, sub.view_proj, sub.light,
                                    sub.sampling_mode, spec.width,
                                    spec.height, near_clip=sub.near_clip)


# ------------------------------------------------------------------ scenes


class Scene:
    """A frame function with what the report needs (not a package scene:
    the translucent scenes are defined here, as bench.py defines its
    ordered scene)."""

    def __init__(self, name, width, height, n_tris, frame, submission=None):
        self.name, self.width, self.height = name, width, height
        self.n_tris, self.frame, self.submission = n_tris, frame, submission


def translucent_sphere(width, height, device, n_lat=50, n_lon=52,
                       engine="tile"):
    """bench.py's ordered scene: uv_sphere(50, 52) (5,096 triangles),
    colour (0.8, 0.5, 0.9, 0.5), gouraud, model (0,0,-3) rotate_y(0.4)
    scale 1.4, light (0.4, 0.6, 1.0) ambient 0.15, over a cleared
    framebuffer; frame t turns it by rotate_y(t - 0.5)."""
    import numpy as np
    import torch

    from dtrenderer_tpu_torch.models import primitives
    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec, draw_mesh_ordered
    from dtrenderer_tpu_torch.ops.shading import make_light
    from dtrenderer_tpu_torch.models.scenes import Submission
    from dtrenderer_tpu_torch.utils import math3d as m3

    proj = m3.perspective(np.pi / 3, width / height, 0.1, 100.0,
                          device=device)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=device)
    mesh = primitives.uv_sphere(n_lat, n_lon, device=device)
    mdl = m3.model_matrix((0, 0, -3.0), m3.rotate_y(0.4, device=device), 1.4,
                          device=device)
    col = (0.8, 0.5, 0.9, 0.5)

    def submission(t):
        rot = m3.rotate_y(torch.as_tensor(t, dtype=torch.float32) - 0.5,
                          device=device)
        return Submission(proj, [DrawSpec(mesh, m3.mat4mul(mdl, rot),
                                          color=col, shading="gouraud")],
                          light, "nearest", True)

    def frame(color, depth, t):
        sub = submission(t)
        d = sub.draws[0]
        fb = fblib.clear(fblib.Framebuffer(color, depth),
                         [0.02, 0.02, 0.05, 1.0])
        out = draw_mesh_ordered(fb, d.mesh, d.model, proj, light=light,
                                color=col, shading="gouraud", engine=engine)
        return out.color, out.depth

    return Scene(f"translucent_sphere_{engine}", width, height,
                 mesh.num_tris, frame, submission)


def mixed_config4(spec4):
    """Config 4's draws with the first sphere translucent (alpha 0.6) and
    submitted between the opaque draws: opaque runs [head, cube] and
    [sphere 2], with the translucent sphere between them."""
    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec, draw_meshes

    def frame(color, depth, t):
        sub = spec4.submission(t)
        head, cube, sphere, sphere2 = sub.draws
        trans = DrawSpec(sphere.mesh, sphere.model,
                         color=(0.8, 0.5, 0.9, 0.6), shading="phong")
        fb = fblib.clear(fblib.Framebuffer(color, depth),
                         [0.03, 0.03, 0.06, 1.0])
        fb = draw_meshes(fb, sub.view_proj, [head, cube, trans, sphere2],
                         light=sub.light, sampling_mode=sub.sampling_mode)
        return fb.color, fb.depth

    return Scene("config4_translucent_sphere", spec4.width, spec4.height,
                 spec4.n_tris, frame)


# ------------------------------------------------------- kernel vs twin


def k1_ops(batch, bins, height, width, shaded=None):
    """float32 operations K1 must do on these inputs: the edge functions of
    every binned pair's pixels in its bbox, barycentrics and z of every
    covered pixel, and the shading of the pixels in `shaded` (bool [H, W];
    every covered pixel when None), by their winners' flags (K2's twin
    gives the winners)."""
    from dtrenderer_tpu_torch.ops import raster_pallas as rp

    _, tri = rp.rasterize_pallas_plain(batch.coef, bins, height, width)
    covered = tri >= 0
    shaded = covered if shaded is None else shaded & covered
    return (edge_pixels(batch.bbox, bins, width) * EDGE_OPS
            + int(covered.sum()) * BARY_Z_OPS
            + shade_ops(batch.payload[tri[shaded].long(), 3]))


def k1_vs_plain(spec, card):
    """K1 for one scene: (max_abs_err, kernel ms, plain ms, bound, share of
    surviving coarse bits, the two launch-loop readings)."""
    import torch

    from dtrenderer_tpu_torch.ops import render_fused as rf

    sub, batch = pack_submission(spec)
    bins = bin_batch(batch, spec.height, spec.width)
    args = (batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            spec.height, spec.width)
    z_k, src_k, _ = rf.render_fused(*args)
    z_p, src_p, _ = rf.render_fused_plain(*args)
    torch.cuda.synchronize()
    bin_report(f"K1 {spec.name} {spec.width}x{spec.height}", batch, bins)
    err = compare(f"K1 {spec.name} kernel vs plain twin", z_k, src_k, z_p,
                  src_p)
    k_ms, p_ms, r = interleaved_ms(lambda: rf.render_fused(*args),
                                   lambda: rf.render_fused_plain(*args), 20)
    ops = k1_ops(batch, bins, spec.height, spec.width)
    n_bytes = nbytes(batch.coef, batch.payload, bins.tile_start,
                     bins.tri_ids, batch.tex_lut, z_k, src_k)
    b = bound(n_bytes, ops)
    share = surviving_bits(batch.coef, bins, spec.height, spec.width)
    from dtrenderer_tpu_torch.kernels import render_fused as k1

    scal = rf.light_scalars(sub.light)
    loop = launch_loop_ms(lambda: k1.launch(
        batch.coef, batch.payload, bins.tile_start, bins.tri_ids,
        batch.tex_lut, scal, z_k, src_k, spec.height, spec.width, 0, 0))
    print(f"K1 {spec.name}: kernel {k_ms:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), "
          f"launch loop {loop[0]:.4f}, {loop[1]:.4f} ms, "
          f"plain twin {p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), bound "
          f"{b[0]:.4f} ms by {b[1]} ({n_bytes} bytes, {ops} f32 ops), "
          f"surviving coarse bits {share:.4f} [{card}]")
    return err, k_ms, p_ms, b, share, loop


def k2_vs_plain(spec, card):
    """K2 on each draw of one scene (the main path launches it once per
    draw): (max |z diff|, summed kernel ms, summed plain ms, bound, share of
    surviving coarse bits over all draws' pairs, the two launch-loop
    readings summed over the draws)."""
    import torch

    from dtrenderer_tpu_torch.ops import pipeline
    from dtrenderer_tpu_torch.ops import raster_pallas as rp
    from dtrenderer_tpu_torch.ops import render_fused as rf

    from dtrenderer_tpu_torch.kernels import raster_visibility as k2

    sub = spec.submission(0.5)
    k_ms = p_ms = err = kept = 0.0
    loop = [0.0, 0.0]
    n_bytes = n_ops = n_pairs = 0
    for i, d in enumerate(sub.draws):
        batch = pipeline.pack_draws([d], sub.view_proj, sub.light,
                                    sub.sampling_mode, spec.width,
                                    spec.height, near_clip=sub.near_clip)
        bins = bin_batch(batch, spec.height, spec.width)
        args = (batch.coef, bins, spec.height, spec.width)
        z_k, t_k = rp.rasterize_bins(*args)
        z_p, t_p = rp.rasterize_pallas_plain(*args)
        torch.cuda.synchronize()
        tag = f"K2 {spec.name} draw {i}"
        bin_report(tag, batch, bins)
        if not torch.equal(z_k.view(torch.int32), z_p.view(torch.int32)):
            raise AssertionError(f"{tag}: z differs at "
                                 f"{int((z_k != z_p).sum())} pixels")
        if not torch.equal(t_k, t_p):
            raise AssertionError(f"{tag}: tri differs at "
                                 f"{int((t_k != t_p).sum())} pixels")
        hit = torch.isfinite(z_k)
        if bool(hit.any()):
            err = max(err, float((z_k[hit] - z_p[hit]).abs().max()))
        print(f"{tag}: z bit-equal (max |diff| {err:.3g}), tri equal, "
              f"covered px {int((t_k >= 0).sum())}")
        k, p, r = interleaved_ms(lambda: rp.rasterize_bins(*args),
                                 lambda: rp.rasterize_pallas_plain(*args), 20)
        lp = launch_loop_ms(lambda: k2.launch(
            batch.coef, bins.tile_start, bins.tri_ids, z_k, t_k, spec.height,
            spec.width, 0, 0))
        print(f"{tag}: kernel {k:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), launch "
              f"loop {lp[0]:.4f}, {lp[1]:.4f} ms, plain "
              f"twin {p:.4f} ms ({r[0]:.4f}, {r[3]:.4f}) [{card}]")
        k_ms, p_ms = k_ms + k, p_ms + p
        loop = [loop[0] + lp[0], loop[1] + lp[1]]
        n_bytes += nbytes(batch.coef, bins.tile_start, bins.tri_ids, z_k,
                          t_k)
        n_ops += (edge_pixels(batch.bbox, bins, spec.width) * EDGE_OPS
                  + int((t_k >= 0).sum()) * BARY_Z_OPS)
        pairs = bins.tri_ids.shape[0]
        kept += pairs * surviving_bits(batch.coef, bins, spec.height,
                                       spec.width)
        n_pairs += pairs
    b = bound(n_bytes, n_ops)
    share = kept / max(1, n_pairs)
    print(f"K2 {spec.name}: kernel {k_ms:.4f} ms, launch loop "
          f"{loop[0]:.4f}, {loop[1]:.4f} ms, plain twin {p_ms:.4f} ms "
          f"over {len(sub.draws)} draw(s), bound {b[0]:.4f} ms by {b[1]} "
          f"({n_bytes} bytes, {n_ops} f32 ops), surviving coarse bits "
          f"{share:.4f} [{card}]")
    return err, k_ms, p_ms, b, share, tuple(loop)


def k3_vs_plain(scene, card):
    """K3 at the translucent sphere: (max |colour diff|, kernel ms, plain
    ms, bound, the two launch-loop readings)."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops import raster_ordered as ro
    from dtrenderer_tpu_torch.ops import render_fused as rf

    sub, batch = pack_submission(scene)
    bins = bin_batch(batch, scene.height, scene.width)
    fb = fblib.clear(fblib.create(scene.height, scene.width,
                                  batch.coef.device), [0.02, 0.02, 0.05, 1.0])
    args = (batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            fb.color, fb.depth, scene.height, scene.width)
    c_k, d_k = ro.render_ordered_bins(*args)
    c_p, d_p = ro.render_ordered_plain(*args)
    torch.cuda.synchronize()
    bin_report(f"K3 {scene.name} {scene.width}x{scene.height}", batch, bins)
    err = compare(f"K3 {scene.name} kernel vs plain twin", d_k, c_k, d_p,
                  c_p)
    k_ms, p_ms, r = interleaved_ms(lambda: ro.render_ordered_bins(*args),
                                   lambda: ro.render_ordered_plain(*args), 20)
    covered = int(torch.isfinite(d_k).sum())
    # each covered pixel is shaded and blended at least once (a lower
    # bound: where layers stack, once per layer)
    ops = (edge_pixels(batch.bbox, bins, scene.width) * EDGE_OPS
           + covered * (BARY_Z_OPS + BLEND_OPS)
           + shade_ops(batch.payload[:1, 3].expand(covered)))
    n_bytes = nbytes(batch.coef, batch.payload, bins.tile_start,
                     bins.tri_ids, batch.tex_lut, fb.color, fb.depth, c_k,
                     d_k)
    b = bound(n_bytes, ops)
    from dtrenderer_tpu_torch.kernels import render_ordered as k3

    scal = rf.light_scalars(sub.light)
    loop = launch_loop_ms(lambda: k3.launch(
        batch.coef, batch.payload, bins.tile_start, bins.tri_ids,
        batch.tex_lut, scal, fb.color, fb.depth, c_k, d_k, scene.height,
        scene.width, 0, 0))
    print(f"K3 {scene.name}: kernel {k_ms:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), "
          f"launch loop {loop[0]:.4f}, {loop[1]:.4f} ms "
          f"({loop[0] / b[0]:.2f}x, {loop[1] / b[0]:.2f}x the bound), "
          f"plain twin {p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), bound "
          f"{b[0]:.4f} ms by {b[1]} ({n_bytes} bytes, {ops} f32 ops) "
          f"[{card}]")
    return err, k_ms, p_ms, b, loop


# The deferred shading kernel (DS): float32 operations per winning pixel
# besides its shading (shade_ops) and blend (BLEND_OPS): three edge
# functions (2 mul, 2 add each) and three barycentric products; bytes per
# pixel: z, tri, depth and colour read, colour and depth written.
DS_BARY_OPS = 15
DS_PIXEL_BYTES = 4 + 4 + 4 + 16 + 16 + 4
DS_SETUP_BYTES = 48  # the setup row's first three float4 (edges, inv_area2)


def ds_vs_plain(spec, card):
    """DS on each draw of a "pallas" scene as the main path runs it: K2's z
    and tri of the draw, shaded into the framebuffer that the draws before
    it made (the first a cleared one); pipeline.shade_deferred on the card
    against shade_deferred_plain, depth bit-equal and colour max |diff| 0.
    Returns (max |colour diff|, summed wrapper ms, summed plain ms, bound,
    the two launch-loop readings summed over the draws)."""
    import torch

    from dtrenderer_tpu_torch.kernels import shade_deferred as kds
    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline
    from dtrenderer_tpu_torch.ops import raster_pallas as rp
    from dtrenderer_tpu_torch.ops import render_fused as rf

    dev = torch.device(DEVICE)
    h, w = spec.height, spec.width
    sub = spec.submission(0.5)
    fb = fblib.create(h, w, dev)
    k_ms = p_ms = err = 0.0
    loop = [0.0, 0.0]
    n_bytes = n_ops = 0
    for i, d in enumerate(sub.draws):
        staged = pipeline.stage_draw_mesh(
            dev, d.mesh, d.model, sub.view_proj, h, w, texture=d.texture,
            light=sub.light, color=d.color, shading=d.shading,
            sampling_mode=sub.sampling_mode, backend="pallas",
            near_clip=sub.near_clip)
        setup = staged.setup
        z, tri = rp.rasterize_bins(setup.coef, bin_batch(setup, h, w), h, w)
        attrs = staged.attrs10  # a view of row stride 34, read in place
        lut = staged.texture.contiguous().reshape(-1, 4)
        args = (fb, z, tri, setup.coef, attrs, staged.texture,
                staged.sampling_mode, staged.shading, staged.light)
        got = pipeline.shade_deferred(*args)
        want = pipeline.shade_deferred_plain(*args)
        torch.cuda.synchronize()
        tag = f"DS {spec.name} draw {i}"
        if not torch.equal(got.depth.view(torch.int32),
                           want.depth.view(torch.int32)):
            raise AssertionError(f"{tag}: depth differs at "
                                 f"{int((got.depth != want.depth).sum())} "
                                 f"pixels")
        e = float((got.color - want.color).abs().max())
        if not e == 0.0:
            raise AssertionError(f"{tag}: colour max |diff| {e}, want 0")
        win = (tri >= 0) & (z < fb.depth)
        n_win = int(win.sum())
        print(f"{tag}: depth bit-equal, colour max |diff| {e:.3g}, winning "
              f"px {n_win}")
        k, pl, r = interleaved_ms(
            lambda: pipeline.shade_deferred(*args),
            lambda: pipeline.shade_deferred_plain(*args), 20)
        if lut.data_ptr() % 16:
            raise AssertionError(f"{tag}: texture not 16-byte aligned")
        flags = rf.pack_flags(staged.shading == "phong",
                              staged.sampling_mode == "bilinear")
        th, tw = staged.texture.shape[0], staged.texture.shape[1]
        scal = rf.light_scalars(staged.light)
        out_c, out_d = torch.empty_like(fb.color), torch.empty_like(fb.depth)
        lp = launch_loop_ms(lambda: kds.launch(
            z, tri, fb.depth, fb.color, setup.coef, attrs, lut, scal, out_c,
            out_d, tw, th, flags, h, w, 0, 0))
        print(f"{tag}: wrapper {k:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), launch "
              f"loop {lp[0]:.4f}, {lp[1]:.4f} ms, plain twin {pl:.4f} ms "
              f"({r[0]:.4f}, {r[3]:.4f}) [{card}]")
        k_ms, p_ms, err = k_ms + k, p_ms + pl, max(err, e)
        loop = [loop[0] + lp[0], loop[1] + lp[1]]
        # the rows and attribute channels of the triangles that win a pixel
        # (7 of a corner's 10, all 10 with Phong), the texture once
        n_rows = int(torch.unique(tri[win]).numel())
        attr_bytes = 3 * 4 * (10 if staged.shading == "phong" else 7)
        n_bytes += (h * w * DS_PIXEL_BYTES
                    + n_rows * (DS_SETUP_BYTES + attr_bytes) + nbytes(lut))
        n_ops += (n_win * (DS_BARY_OPS + BLEND_OPS)
                  + shade_ops(torch.full((n_win,), flags, device=dev)))
        fb = got
    b = bound(n_bytes, n_ops)
    print(f"DS {spec.name}: wrapper {k_ms:.4f} ms, launch loop "
          f"{loop[0]:.4f}, {loop[1]:.4f} ms ({loop[0] / b[0]:.2f}x, "
          f"{loop[1] / b[0]:.2f}x the bound), plain twin {p_ms:.4f} ms over "
          f"{len(sub.draws)} draw(s), bound {b[0]:.4f} ms by {b[1]} "
          f"({n_bytes} bytes, {n_ops} f32 ops) [{card}]")
    return err, k_ms, p_ms, b, tuple(loop)


# K1's merge epilogue (render_fused with a framebuffer, the draw call's
# path): per pixel the framebuffer's colour and depth read and the merged
# pair written in place of z and src; per winning pixel one blend
# (BLEND_OPS).
FB_PIXEL_BYTES = 16 + 4


def seeded_fb(z, seed: int):
    """A framebuffer over z's frame, on z's card, over which some covered
    pixels win and some lose: depth +inf (a covered pixel wins), z itself
    (a tie: it loses), uniform in [0, 1) or NaN (never wins); colour
    uniform in [0, 1)."""
    import torch

    from dtrenderer_tpu_torch.ops.fb import Framebuffer

    g = torch.Generator(device=z.device).manual_seed(seed)
    u = torch.rand(z.shape, generator=g, device=z.device)
    other = torch.rand(z.shape, generator=g, device=z.device)
    depth = torch.where(u < 0.4, float("inf"), torch.where(
        u < 0.6, z, torch.where(u < 0.95, other, float("nan"))))
    color = torch.rand((*z.shape, 4), generator=g, device=z.device)
    return Framebuffer(color, depth)


def same_fb(tag, got, want):
    """Depth and colour bit-equal, NaN at the same places; returns the max
    |colour diff| over the other channels (0)."""
    same_bits_nan(f"{tag} depth", got.depth, want.depth)
    same_bits_nan(f"{tag} colour", got.color, want.color)
    return float((got.color - want.color).nan_to_num().abs().max())


def k1_merge_vs_plain(spec, card, rows: int = 1):
    """K1's merging entry (render_fused(..., fb=...), the draw call's path)
    against its twin (render_fused_plain(..., fb=...), the torch merge) on
    one scene's frame over a seeded framebuffer, whole (rows 1) or in `rows`
    row bands of the shared table, each band's launch writing its rows of
    one pair of planes as pipeline._render_banded does: depth and colour
    bit-equal (NaN at the same places), winners counted equal, the
    framebuffer unwritten. With rows 1 also timed: the merging wrapper
    against the twin, K1's launch loop with and without the merge, the
    torch merge alone over K1's (z, src); and the bound. Returns (max
    |colour diff|, wrapper ms, plain ms, bound, winners, torch merge ms,
    launch loop without the merge, launch loop with it)."""
    import torch

    from dtrenderer_tpu_torch.kernels import render_fused as k1
    from dtrenderer_tpu_torch.ops import binning
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.ops.fb import Framebuffer

    dev = torch.device(DEVICE)
    h, w = spec.height, spec.width
    bh = h // rows
    sub, batch = pack_submission(spec)
    all_bins = ([bin_batch(batch, h, w)] if rows == 1 else binning.bin_bands(
        batch.coef, batch.bbox, batch.valid, h, w, rows, 0, 0, rf.TILE_H,
        rf.TILE_W))

    def band_args(i, b):
        return (batch.coef, batch.payload, b, batch.tex_lut, sub.light, bh, w,
                i * bh, 0)

    z = torch.cat([rf.render_fused(*band_args(i, b))[0]
                   for i, b in enumerate(all_bins)])
    fb = seeded_fb(z, 5)
    before = [t.clone() for t in fb]

    def merged(fn):
        out = Framebuffer(torch.empty_like(fb.color),
                          torch.empty_like(fb.depth))
        count = torch.zeros((), dtype=torch.int32, device=dev)
        for i, b in enumerate(all_bins):
            ys = slice(i * bh, (i + 1) * bh)
            _, _, n = fn(*band_args(i, b),
                         fb=Framebuffer(fb.color[ys], fb.depth[ys]),
                         out=(out.color[ys], out.depth[ys]),
                         count_shaded=True)
            count += n
        return out, int(count)

    got, n_k = merged(rf.render_fused)
    want, n_p = merged(rf.render_fused_plain)
    torch.cuda.synchronize()
    tag = f"K1 merge {spec.name}" + (f" in {rows} bands" if rows > 1 else "")
    err = same_fb(tag, got, want)
    win = z < fb.depth
    if not (n_k == n_p == int(win.sum()) > 0):
        raise AssertionError(f"{tag}: winners {n_k} (kernel), {n_p} "
                             f"(plain), {int(win.sum())} (z < depth)")
    for a, b in zip(before, fb):
        same_bits_nan(f"{tag}: the framebuffer", b, a)
    print(f"{tag}: depth bit-equal, colour max |diff| {err:.3g} (NaN at the "
          f"same places), winners {n_k} = plain = (z < depth).sum(), of "
          f"{int(torch.isfinite(z).sum())} covered px, framebuffer unwritten"
          f" [{card}]")
    if rows > 1:
        return err
    bins = all_bins[0]
    args = band_args(0, bins)
    k_ms, p_ms, r = interleaved_ms(
        lambda: rf.render_fused(*args, fb=fb, count_shaded=True),
        lambda: rf.render_fused_plain(*args, fb=fb, count_shaded=True), 20)
    scal = rf.light_scalars(sub.light)
    kin = (batch.coef, batch.payload, bins.tile_start, bins.tri_ids,
           batch.tex_lut, scal)
    zs, srcs = torch.empty_like(fb.depth), torch.empty_like(fb.color)
    out = Framebuffer(torch.empty_like(fb.color), torch.empty_like(fb.depth))
    count = torch.zeros((), dtype=torch.int32, device=dev)
    loop_plain = launch_loop_ms(lambda: k1.launch(*kin, zs, srcs, h, w, 0, 0))
    loop_merge = launch_loop_ms(lambda: k1.launch(
        *kin, None, None, h, w, 0, 0, fb_color=fb.color, fb_depth=fb.depth,
        out_color=out.color, out_depth=out.depth, shaded=count))
    z_k, src_k, _ = rf.render_fused(*args)
    t_merge = (cuda_ms(lambda: rf.merge_plain(fb, z_k, src_k, None, True),
                       20),
               cuda_ms(lambda: rf.merge_plain(fb, z_k, src_k, None, True),
                       20))
    ops = k1_ops(batch, bins, h, w, shaded=win) + n_k * BLEND_OPS
    n_bytes = (nbytes(batch.coef, batch.payload, bins.tile_start,
                      bins.tri_ids, batch.tex_lut)
               + 2 * h * w * FB_PIXEL_BYTES)
    b = bound(n_bytes, ops)
    print(f"{tag}: merging wrapper {k_ms:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), "
          f"plain twin {p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}); launch loop "
          f"with the merge {loop_merge[0]:.4f}, {loop_merge[1]:.4f} ms, "
          f"without {loop_plain[0]:.4f}, {loop_plain[1]:.4f} ms; the torch "
          f"merge alone {t_merge[0]:.4f}, {t_merge[1]:.4f} ms; bound "
          f"{b[0]:.4f} ms by {b[1]} ({n_bytes} bytes, {ops} f32 ops) "
          f"[{card}]")
    return err, k_ms, p_ms, b, n_k, min(t_merge), loop_plain, loop_merge


def merge_device_ops(spec, card) -> dict:
    """Device operations of one steady frame of a scene on "fused"
    (spec.frame: the vertex stage's replay, binning, K1, the clear), with
    the merge in K1's epilogue and with the draw call's torch merge it
    replaced (pipeline.render_fused swapped for K1 without a framebuffer
    and its plain merge); torch.profiler, after two warm-up frames each.
    Returns {before, after: (ops, device us)}."""
    import torch
    from unittest import mock

    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline
    from dtrenderer_tpu_torch.ops import render_fused as rf

    fb0 = fblib.create(spec.height, spec.width, torch.device(DEVICE))

    def before_merge(*args, fb=None, out=None, count_shaded=False):
        z, src, overflow = rf.render_fused(*args)
        merged, n = rf.merge_plain(fb, z, src, out, count_shaded)
        return merged, overflow, n

    def frame():
        spec.frame(fb0.color, fb0.depth, 0.5)

    res = {}
    for name, patch in (("before", before_merge), ("after", None)):
        with mock.patch.object(pipeline, "render_fused",
                               patch or rf.render_fused):
            for _ in range(2):
                frame()
            ops = device_ops(frame)
        res[name] = (len(ops), sum(us for _, us in ops))
        print(f"{spec.name} device ops a frame, {name} the merge moved into "
              f"K1: {len(ops)} ops, {res[name][1]:.1f} us: "
              f"{short_ops(ops)} [{card}]")
    return res


def stress_vs_plain():
    """K1 and K2 against their plain twins, bit for bit, at shapes the
    scenes do not reach (models/stress.py): a tile of more than 512
    triangles (three staging chunks of the walk), grids whose shared edges
    run through pixel centres and along sub-block borders, each as a whole
    frame and as two shards whose size is no multiple of the tile or the
    sub-block, at non-zero offsets; K1 with and without its merge (over a
    seeded framebuffer, winners counted)."""
    import torch

    from dtrenderer_tpu_torch.models import stress
    from dtrenderer_tpu_torch.ops import binning
    from dtrenderer_tpu_torch.ops import raster_pallas as rp
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.ops.shading import make_light

    dev = torch.device(DEVICE)
    light = make_light((0.4, 0.6, 1.0), 0.15, device=dev)
    for tag, make in stress.CASES.items():
        corners, h, w = make()
        setup = stress.setup(corners, h, w, dev)
        payload, lut = stress.payload(corners, 5, dev)
        for y0, x0, bh, bw in stress.windows(h, w):
            bins = binning.bin_triangles(setup.coef, setup.bbox, setup.valid,
                                         bh, bw, y0, x0, rf.TILE_H, rf.TILE_W)
            deepest = int((bins.tile_start[1:] - bins.tile_start[:-1]).max())
            if tag == "deep_tile" and (y0, x0) == (0, 0) and deepest <= 512:
                raise AssertionError(f"deep tile: deepest bin {deepest}")
            z2, t2 = rp.rasterize_bins(setup.coef, bins, bh, bw, y0, x0)
            z2p, t2p = rp.rasterize_pallas_plain(setup.coef, bins, bh, bw, y0,
                                                 x0)
            args = (setup.coef, payload, bins, lut, light, bh, bw, y0, x0)
            z1, s1, _ = rf.render_fused(*args)
            z1p, s1p, _ = rf.render_fused_plain(*args)
            torch.cuda.synchronize()
            where = f"stress {tag} {bw}x{bh} at ({x0}, {y0})"
            for name, a, b in (("K2 z", z2, z2p), ("K2 tri", t2, t2p),
                               ("K1 z", z1, z1p), ("K1 src", s1, s1p)):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(
                        f"{where}: {name} differs at "
                        f"{int((a != b).sum())} elements")
            covered = int((t2 >= 0).sum())
            if covered <= 100:
                raise AssertionError(f"{where}: only {covered} px covered")
            fb = seeded_fb(z1p, 3)
            got, _, n = rf.render_fused(*args, fb=fb, count_shaded=True)
            want, _, n_p = rf.render_fused_plain(*args, fb=fb,
                                                 count_shaded=True)
            same_fb(f"{where}: K1 merge", got, want)
            if int(n) != int(n_p):
                raise AssertionError(f"{where}: K1 merge winners {int(n)}, "
                                     f"plain {int(n_p)}")
            print(f"{where}: K1 and K2 bit-equal to their plain twins, "
                  f"deepest bin {deepest}, covered px {covered}; K1's merge "
                  f"too, {int(n)} winners")


# ------------------------------------------------------ 2D kernel vs twin


def draw2d_kernel_vs_plain(card) -> dict:
    """csrc/draw2d.cu (D2) against its twins on the same inputs at 1920x1080:
    every case of models/draw2d_cases.py through draw2d.draw against
    draw_plain (every verb kind, the edge windows, both text layouts, strings
    longer than one launch), and every render_triangle case through
    draw2d.triangle against the CPU path: colour and depth bit-equal, NaN at
    the same places, the input planes unwritten, one launch a verb. Then the
    API frame's ten D2 launches one by one: the launch loop (200 times the
    verb's prepared entry calls, the whole frame written), the wrapper (20
    calls), the plain twin, and the bound by bytes (32 B a pixel for a
    verb, z and tri written for the triangle). Last, the API
    frame's 2D verbs, text and render_triangle under
    torch.cuda.set_sync_debug_mode("error"): a host read fails the run."""
    import numpy as np
    import torch

    from dtrenderer_tpu_torch import api
    from dtrenderer_tpu_torch.assets.font import encode_text
    from dtrenderer_tpu_torch.kernels import draw2d as kd
    from dtrenderer_tpu_torch.models import draw2d_cases as cases
    from dtrenderer_tpu_torch.ops import draw2d, text
    from dtrenderer_tpu_torch.ops.fb import Framebuffer
    from dtrenderer_tpu_torch.tools import demo
    from dtrenderer_tpu_torch.utils.color import rgba

    dev = torch.device(DEVICE)
    h, w = 1080, 1920
    t0 = time.perf_counter()
    fb = cases.framebuffer(h, w, dev, seed=4)
    before = [t.clone() for t in fb]
    n_verbs = n_full = 0
    errs = []  # (max |got - want|, elements differing) of each comparison

    def check(tag, got, want):
        errs.append(abs_err(got, want))
        same_bits_nan(tag, got, want)
    for case in cases.verb_cases(h, w, dev, seed=11):
        verb = case.make(fb)
        reset_counts()
        got = draw2d.draw(fb, verb)
        torch.cuda.synchronize()
        n = read_counts()["D2"]
        want_n = (0 if verb.window.empty else
                  -(-verb.text.codes.shape[0] // 256)
                  if verb.kind == draw2d.TEXT else 1)
        if n != want_n:
            raise AssertionError(f"2D {case.name}: {n} launches, want "
                                 f"{want_n}")
        want = draw2d.draw_plain(fb, verb)
        check(f"2D kernel vs plain {case.name}", got.color, want.color)
        n_verbs += 1
        n_full += verb.window == draw2d.Window.full(h, w)
    tex = cases.bitmap(dev, seed=9, shape=(64, 64))
    fb_cpu = Framebuffer(fb.color.cpu(), fb.depth.cpu())
    n_tris = 0
    for case in cases.triangle_cases(h, w, seed=11):
        for t in (tex, None):
            got = draw2d.triangle(fb, case.corners, t, case.sampling,
                                  case.cull_backfaces)
            want = draw2d.triangle(fb_cpu, case.corners,
                                   None if t is None else t.cpu(),
                                   case.sampling, case.cull_backfaces)
            for name in ("color", "depth"):
                check(f"render_triangle {case.name} {name}",
                      getattr(got, name).cpu(), getattr(want, name))
            n_tris += 1
    for a, b in zip(before, fb):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("2D kernel vs plain: a verb wrote its input")
    max_err = max(e for e, _ in errs)
    n_diff = sum(n for _, n in errs)
    print(f"2D kernel vs plain: {n_verbs} verbs ({n_full} on the whole "
          f"frame) and {n_tris} render_triangle calls at {w}x{h} bit-equal "
          f"to the plain path (max |got - want| {max_err}, {n_diff} elements "
          f"differing), input planes unwritten, "
          f"{time.perf_counter() - t0:.1f} s")

    # the API frame's ten D2 launches
    frame = demo.ApiFrame(w, h, dev)
    state = frame.update(api.new_state(w, h, device=dev), 0.6)
    sfb = state.fb
    hud_lines = ["frame: %7.2f ms" % 16.67, "tris: 12345/23456  px: 778094",
                 "API frame %dx%d" % (w, h)]
    verbs = {
        "rectangle": draw2d.rect_verb(sfb, (20, h - 90), (120, h - 20),
                                      rgba(0.9, 0.2, 0.2, 0.6)),
        "rectangle rotated": draw2d.rect_verb(
            sfb, (70, h - 110), (180, h - 60), rgba(0.2, 0.6, 0.9, 0.5),
            api.transform2d(rotation=0.48, device=dev)),
        "line": draw2d.line_verb(sfb, (w - 180, h - 30), (w - 30, h - 100),
                                 rgba(1, 1, 0.3, 1)),
        "circle": draw2d.circle_verb(sfb, (w - 100, h - 140), 28,
                                     rgba(0.3, 0.9, 0.4, 0.8), None),
        "bitmap": draw2d.blit_verb(
            sfb, demo._blit_bitmap(dev), (w - 220, 40),
            api.transform2d(rotation=-0.6, scale=3.0, device=dev),
            "bilinear"),
        **{f"HUD line {i}": text.text_verb(
            sfb, frame.hud.font, encode_text(ln), (4, 4 + i * (
                frame.hud.font.cell_h + 2)), (1.0, 1.0, 1.0, 1.0), 1, False)
           for i, ln in enumerate(hud_lines)},
        "footer": text.text_verb(
            sfb, frame.sans, encode_text(demo.FOOTER),
            (8, h - frame.sans.cell_h - 6), demo.FOOTER_COLOR, 1, True),
    }
    color = sfb.color.contiguous()
    out = torch.empty_like(color)
    plane = 2 * color.numel() * color.element_size()
    rows = {}
    for name, verb in verbs.items():
        made = kd.calls(verb, color, out)  # the entry calls, made ready

        def loop(made=made):
            for fn, args in made:
                fn(*args)

        a = launch_loop_ms(loop)
        wrapper = cuda_ms(lambda verb=verb: draw2d.draw(sfb, verb), 20)
        plain = cuda_ms(lambda verb=verb: draw2d.draw_plain(sfb, verb), 3)
        bnd = bound(plane, 0)
        rows[name] = (min(a), wrapper, plain, bnd[0])
        print(f"D2 {name}: window {tuple(verb.window)}, loop {a[0]:.4f}, "
              f"{a[1]:.4f} ms, wrapper {wrapper:.4f}, plain {plain:.4f}, "
              f"bound {bnd[0]:.4f} ms by bytes ({plane} B) [{card}]")
    corners = np.asarray([
        [0.30 * w, 0.08 * h, 0.05, 1.0, 0, 1, 1.0, 1.0, 1.0, 0.9],
        [0.46 * w, 0.12 * h, 0.05, 0.5, 1, 1, 1.0, 1.0, 1.0, 0.9],
        [0.34 * w, 0.30 * h, 0.05, 0.25, 0, 0, 1.0, 1.0, 1.0, 0.9]],
        np.float32)
    coef, bbox, valid = draw2d.setup_host(corners[:, :4], w, h, False)
    win = draw2d.Window(bbox[1], bbox[3] + 1, bbox[0], bbox[2] + 1)
    attrs = draw2d.corner_attrs_host(corners)
    z = torch.empty((h, w), device=dev)
    tri = torch.empty((h, w), dtype=torch.int32, device=dev)
    rows_out = (torch.empty((1, 16), device=dev),
                torch.empty((1, 3, 10), device=dev))
    tl = launch_loop_ms(lambda: kd.triangle(coef, attrs, win, z, tri,
                                            *rows_out))
    t_plain = cuda_ms(lambda: draw2d.triangle_gbuffer_plain(
        torch.from_numpy(coef[None]).to(dev), win, h, w), 3)
    zp, tp = draw2d.triangle_gbuffer_plain(torch.from_numpy(coef[None]).to(dev),
                                           win, h, w)
    check("D2 triangle G-buffer z", z, zp)
    check("D2 triangle G-buffer tri", tri, tp)
    max_err = max(e for e, _ in errs)
    n_diff = sum(n for _, n in errs)
    # the setup on CPU tensors (setup_host) against the same function on
    # the card, for this triangle and every render_triangle case
    from dtrenderer_tpu_torch.ops import geometry

    n_setups = 0
    for cs in [corners, *(c.corners for c in cases.triangle_cases(
            h, w, seed=11))]:
        for cull in (False, True):
            hc, hb, hv = draw2d.setup_host(cs[:, :4], w, h, cull)
            c = torch.from_numpy(np.ascontiguousarray(cs[:, :4])).to(dev)
            setup = geometry.triangle_setup_from_corners(
                c[0:1], c[1:2], c[2:3], w, h, cull)
            same_bits_nan("setup_host vs the card's setup",
                          setup.coef[0].cpu(), torch.from_numpy(hc))
            if setup.bbox[0].tolist() != hb or bool(setup.valid[0]) != hv:
                raise AssertionError("setup_host's bbox or valid differs "
                                     "from the card's setup")
            n_setups += 1
    tb = bound(nbytes(z, tri), 0)
    rows["triangle G-buffer"] = (min(tl), None, t_plain, tb[0])
    print(f"D2 triangle G-buffer: window {tuple(win)}, loop {tl[0]:.4f}, "
          f"{tl[1]:.4f} ms, plain {t_plain:.4f}, bound {tb[0]:.4f} ms by "
          f"bytes; setup_host = the card's setup bit for bit on {n_setups} "
          f"triangles [{card}]")
    total = {k: sum(r[i] for r in rows.values() if r[i] is not None)
             for i, k in enumerate(("loop_ms", "wrapper_ms", "plain_ms",
                                    "bound_ms"))}
    print(f"D2 the API frame's ten launches summed: "
          f"{json.dumps({k: round(v, 4) for k, v in total.items()})} [{card}]")

    # no host read: the API frame's 2D part under sync debug mode "error"
    def overlay():
        st = api.render_rectangle(state, (20, h - 90), (120, h - 20),
                                  rgba(0.9, 0.2, 0.2, 0.6))
        st = api.render_rectangle(st, (70, h - 110), (180, h - 60),
                                  rgba(0.2, 0.6, 0.9, 0.5),
                                  api.transform2d(rotation=0.48, device=dev))
        st = api.render_line(st, (w - 180, h - 30), (w - 30, h - 100),
                             rgba(1, 1, 0.3, 1))
        st = api.render_circle(st, (w - 100, h - 140), 28,
                               rgba(0.3, 0.9, 0.4, 0.8))
        st = api.render_circle(st, (w - 100, h - 140), 28,
                               rgba(0.3, 0.9, 0.4, 0.8), False)
        st = api.render_bitmap(st, demo._blit_bitmap(dev), (w - 220, 40),
                               api.transform2d(rotation=-0.6, scale=3.0,
                                               device=dev),
                               sampling_mode="bilinear")
        st = frame.triangle(st)
        st = api.render_text(st, "one line of text", (4, 200))
        frame.hud.push_text("API frame %dx%d", w, h)
        st = st._replace(fb=frame.hud.render(st.fb, None))
        return demo.draw_footer(st, frame.sans)

    overlay()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        overlay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = host_syncs(overlay)
    print(f"2D verbs, text and render_triangle under "
          f"set_sync_debug_mode('error'): no host read ({syncs} "
          f"synchronisations counted under 'warn') [{card}]")
    return {"rows": rows, "total": total, "max_abs_err": max_err,
            "n_diff": n_diff}


# ------------------------------------------------------------- main paths


def reset_counts():
    from dtrenderer_tpu_torch.ops import binning, draw2d, pipeline
    from dtrenderer_tpu_torch.ops import raster_ordered, raster_pallas
    from dtrenderer_tpu_torch.ops import render_fused, vertex_batch
    from dtrenderer_tpu_torch.ops import vertex_graph

    binning.KERNEL_LAUNCHES = 0
    draw2d.KERNEL_LAUNCHES = 0
    pipeline.KERNEL_LAUNCHES = 0
    render_fused.KERNEL_LAUNCHES = 0
    raster_pallas.KERNEL_LAUNCHES = 0
    raster_ordered.KERNEL_LAUNCHES = 0
    vertex_batch.KERNEL_LAUNCHES = 0
    vertex_graph.REPLAYS = 0


def read_counts() -> dict:
    """Launches of each kernel since reset_counts; "VP", the vertex kernel,
    is launched by vertex_batch.run_pass and by every replay of a graph
    that captured it (vertex_graph.REPLAYS); "BN", the binning kernels, by
    binning.bin_triangles; "DS", the deferred shading kernel, by
    pipeline.shade_deferred; "D2", the 2D verb kernel, by ops/draw2d.py
    draw (every 2D verb and string) and triangle (render_triangle)."""
    from dtrenderer_tpu_torch.ops import binning, draw2d, pipeline
    from dtrenderer_tpu_torch.ops import raster_ordered, raster_pallas
    from dtrenderer_tpu_torch.ops import render_fused, vertex_batch
    from dtrenderer_tpu_torch.ops import vertex_graph

    return {"K1": render_fused.KERNEL_LAUNCHES,
            "K2": raster_pallas.KERNEL_LAUNCHES,
            "K3": raster_ordered.KERNEL_LAUNCHES,
            "VP": vertex_batch.KERNEL_LAUNCHES + vertex_graph.REPLAYS,
            "BN": binning.KERNEL_LAUNCHES,
            "DS": pipeline.KERNEL_LAUNCHES,
            "D2": draw2d.KERNEL_LAUNCHES}


def launches_ok(got: dict, want: dict) -> bool:
    """K1, K2, K3, BN, DS and D2 launched exactly as `want` says (a kernel
    it leaves out: never); the vertex kernel at least want["VP"] times (once
    per pack_draws call: a capture's first call launches it twice, warm-up
    and replay; once per draw staged on "pallas", "ref" or "scan"), or
    never when that is 0."""
    vp_ok = got["VP"] >= want["VP"] if want["VP"] else got["VP"] == 0
    return vp_ok and all(got[k] == want.get(k, 0)
                         for k in ("K1", "K2", "K3", "BN", "DS", "D2"))


def frames(scene, n: int, card, tag: str):
    """n frames through scene.frame, each timed on the host clock up to a
    synchronise; checks every frame's output."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib

    dev = torch.device(DEVICE)
    fb0 = fblib.create(scene.height, scene.width, dev)
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, depth = scene.frame(fb0.color, fb0.depth, 0.5 + 0.1 * i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        covered = int(torch.isfinite(depth).sum())
        if covered <= 0:
            raise AssertionError(f"{scene.name} frame {i}: nothing covered")
        if not (bool(torch.isfinite(color).all())
                and color.shape == (scene.height, scene.width, 4)):
            raise AssertionError(f"{scene.name} frame {i}: bad colour plane")
    dt = min(times)
    print(f"{tag} main path: ms/frame "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)} (best "
          f"{dt * 1e3:.3f}), {covered / dt / 1e6:.1f} shaded Mpix/s, "
          f"{scene.n_tris / dt / 1e6:.2f} Mtris/s, covered px {covered} "
          f"[{card}]")


def main_path(tag, runs, want: dict, card) -> dict:
    """Drive runs = [(scene, n_frames)] with every launch count set to 0
    just before and read just after; the counts must equal `want`."""
    reset_counts()
    for scene, n in runs:
        frames(scene, n, card, f"{tag}: {scene.name}")
    got = read_counts()
    if not launches_ok(got, want):
        raise AssertionError(f"{tag}: kernel launches {got}, want {want}")
    print(f"{tag}: kernel launches {got}")
    return got


# --------------------------------------------------------------- API frame


def differs(a, b, rows) -> bool:
    import torch

    return not torch.equal(a.fb.color[rows], b.fb.color[rows])


def api_frame_path(card) -> dict:
    """The API frame: 3 frames of 1920x1080 through platform.run_app, then
    one demo frame on backend "pallas"; launch counts set to 0 before each
    and read after. Returns the summed launches."""
    import torch

    from dtrenderer_tpu_torch import api, platform
    from dtrenderer_tpu_torch.assets import native
    from dtrenderer_tpu_torch.tools import demo

    dev = torch.device(DEVICE)
    w, h = 1920, 1080
    frame = demo.ApiFrame(w, h, dev)
    times, images = [], []

    def update(state, inp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = frame.update(state, 0.6 + inp.time_now_s)
        img = api.finish_frame(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        i = len(times) - 1
        if not (img.dtype == torch.uint8 and img.shape == (h, w, 4)
                and img.device == dev):
            raise AssertionError(f"API frame {i}: finish_frame gave "
                                 f"{img.dtype} {tuple(img.shape)} on "
                                 f"{img.device}")
        hud_rows = slice(0, 4 + 4 * (frame.hud.font.cell_h + 2))
        foot_rows = slice(h - frame.sans.cell_h - 6, h)
        if not differs(state, frame.before_overlay, hud_rows):
            raise AssertionError(f"API frame {i}: the HUD drew nothing")
        if not differs(state, frame.before_overlay, foot_rows):
            raise AssertionError(f"API frame {i}: the footer drew nothing")
        if not torch.equal(state.fb.depth, frame.before_overlay.fb.depth):
            raise AssertionError(f"API frame {i}: the overlay touched depth")
        submitted, valid, shaded, overflow = (int(c) for c in frame.counters)
        # near clipping makes two setup rows of every submitted triangle
        if submitted != 2 * frame.n_tris or overflow != 0:
            raise AssertionError(
                f"API frame {i}: tris_submitted {submitted} (want "
                f"{2 * frame.n_tris}), bin_overflow {overflow}")
        if not 0 < valid <= submitted or shaded <= 0:
            raise AssertionError(f"API frame {i}: counters {valid} valid, "
                                 f"{shaded} px")
        images.append(img)
        return state

    reset_counts()
    script = platform.InputScript({0: {"press": ["w"]}}, dt=0.03)
    state, n, _ = platform.run_app(update, api.new_state(w, h, device=dev), 3,
                                   script)
    got = read_counts()
    # D2 a frame: two rectangles, the line, the circle, the blit, the
    # triangle's G-buffer, three HUD lines and the footer
    want = {"K1": 3, "K2": 0, "K3": 3, "VP": 6, "BN": 6, "DS": 3,
            "D2": 3 * 10}
    if not launches_ok(got, want) or n != 3:
        raise AssertionError(f"API frame: kernel launches {got}, want {want}")
    if torch.equal(images[0], images[2]):
        raise AssertionError("API frame: frames 0 and 2 are the same image")
    print(f"API frame main path: {w}x{h}, {frame.n_tris} tris, ms/frame "
          f"{', '.join(f'{t:.3f}' for t in times)} (best {min(times):.3f}), "
          f"kernel launches {got} [{card}]")

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "api_frame.png")
    platform.present_png(state, png)
    decoded = native.decode_image_file(png)
    packed = images[-1].cpu().numpy()
    if decoded.shape != packed.shape or decoded.tobytes() != packed.tobytes():
        raise AssertionError("API frame: the PNG does not decode to the "
                             "packed frame")
    print(f"API frame: present_png -> {os.path.relpath(png, REPO)} "
          f"({os.path.getsize(png)} bytes), decoded natively, byte-equal to "
          f"finish_frame")

    # the same demo frame through the visibility kernel + deferred shading
    fused_state, _ = demo.demo_frame(api.new_state(w, h, device=dev), 0.6,
                                     frame.cube, frame.ball, frame.tex,
                                     frame.grad, "fused")
    reset_counts()
    (pallas_state, _), ms = timed(lambda: demo.demo_frame(
        api.new_state(w, h, device=dev), 0.6, frame.cube, frame.ball,
        frame.tex, frame.grad, "pallas"))
    got2 = read_counts()
    want2 = {"K1": 0, "K2": 3, "K3": 0, "VP": 3, "BN": 3, "DS": 3, "D2": 5}
    if not launches_ok(got2, want2):
        raise AssertionError(f"demo frame on pallas: kernel launches {got2}, "
                             f"want {want2}")
    compare("demo frame 1920x1080, backend pallas vs fused",
            pallas_state.fb.depth, pallas_state.fb.color,
            fused_state.fb.depth, fused_state.fb.color)
    print(f"demo frame on pallas main path: {ms:.3f} ms, kernel launches "
          f"{got2} [{card}]")
    verb_times(frame, card, min(times), times)
    return {k: got[k] + got2[k] for k in got}


def verb_times(frame, card, best_ms=None, all_ms=None) -> dict:
    """Each verb of the API frame alone on a 1080p state (after the counted
    windows: these launches are not the main path's). Per verb: "ms", host
    clock to a synchronise, and "host_ms", the host's time in the call up to
    its return (no synchronise), each the best of three; "device_ms", the
    summed durations of the device operations one call enqueues, and
    "launches", their number (kernels, copies, memsets; torch.profiler);
    "host_ops", the ATen operations it dispatches; "syncs", the host
    synchronisations it makes (torch.cuda.set_sync_debug_mode("warn"))."""
    import numpy as np
    import torch

    from dtrenderer_tpu_torch import api
    from dtrenderer_tpu_torch.tools import demo
    from dtrenderer_tpu_torch.utils.color import rgba

    w, h, dev = frame.width, frame.height, frame.device
    state = frame.update(api.new_state(w, h, device=dev), 0.6)
    proj, light, draws = demo.demo_draws(
        np.float32(0.6), w, h, frame.cube, frame.ball, frame.tex, frame.grad,
        dev)
    bmp = demo._blit_bitmap(dev)
    lines = 3

    def hud():
        frame.hud.push_text("chip_smoke API frame %dx%d", w, h)
        return frame.hud.render(state.fb, frame.counters)

    # the demo frame builds its two Transform2D inside the frame: so here
    verbs = {
        "clear": lambda: api.clear(state, rgba(0.06, 0.07, 0.12, 1.0)),
        "render_meshes": lambda: api.render_meshes(
            state, proj, draws, light=light, sampling_mode="bilinear",
            return_counters=True),
        "render_mesh_ordered": lambda: api.render_mesh_ordered(
            state, frame.sphere, frame.sphere_model, frame.proj,
            light=frame.light, color=frame.SPHERE_COLOR, shading="gouraud",
            return_counters=True),
        "render_rectangle": lambda: api.render_rectangle(
            state, (20, h - 90), (120, h - 20), rgba(0.9, 0.2, 0.2, 0.6)),
        "render_rectangle_rotated": lambda: api.render_rectangle(
            state, (70, h - 110), (180, h - 60), rgba(0.2, 0.6, 0.9, 0.5),
            api.transform2d(rotation=0.48, device=dev)),
        "render_line": lambda: api.render_line(
            state, (w - 180, h - 30), (w - 30, h - 100), rgba(1, 1, 0.3, 1)),
        "render_circle": lambda: api.render_circle(
            state, (w - 100, h - 140), 28, rgba(0.3, 0.9, 0.4, 0.8)),
        "render_circle_outline": lambda: api.render_circle(
            state, (w - 100, h - 140), 28, rgba(0.3, 0.9, 0.4, 0.8), False),
        "render_bitmap": lambda: api.render_bitmap(
            state, bmp, (w - 220, 40),
            api.transform2d(rotation=-0.6, scale=3.0, device=dev),
            sampling_mode="bilinear"),
        "render_triangle": lambda: frame.triangle(state),
        "render_text": lambda: api.render_text(state, "one line of text",
                                               (4, 200)),
        f"hud_{lines}_lines": hud,
        "footer": lambda: demo.draw_footer(state, frame.sans),
        "finish_frame": lambda: api.finish_frame(state),
    }
    out = {}
    for name, fn in verbs.items():
        fn()
        ms = [timed(fn)[1] for _ in range(3)]
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ops = max((verb_device_ops(fn) for _ in range(2)), key=len)
        out[name] = {"ms": round(min(ms), 4), "host_ms": round(min(host), 4),
                     "device_ms": round(sum(us for _, us in ops) / 1e3, 4),
                     "launches": len(ops), "host_ops": host_ops(fn),
                     "syncs": host_syncs(fn)}
    two_d = [k for k in out if k not in (
        "clear", "render_meshes", "render_mesh_ordered", "finish_frame")]
    total = {k: round(sum(out[v][k] for v in two_d), 4)
             for k in ("ms", "host_ms", "device_ms", "launches", "host_ops",
                       "syncs")}
    print(f"API frame verbs [{card}]: {json.dumps(out)}")
    print(f"API frame 2D verbs, render_triangle and text summed "
          f"({len(two_d)} calls) [{card}]: {json.dumps(total)}")
    if all_ms is not None:
        print(f"API frame whole, ms [{card}]: "
              f"{json.dumps({'frames': [round(t, 4) for t in all_ms], 'best': round(best_ms, 4)})}")
    return out


def verb_device_ops(fn) -> list:
    """(name, microseconds) of each device operation one fn() enqueues,
    from torch.profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def verb_times_of(root: str) -> int:
    """--verb-times ROOT: verb_times of the package of the checkout at ROOT
    (this tree or another, e.g. a git archive of the parent commit), after
    building its kernels, in a process of its own; one JSON line."""
    import concurrent.futures as cf
    import importlib
    import pkgutil

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import dtrenderer_tpu_torch
    from dtrenderer_tpu_torch import api, kernels
    from dtrenderer_tpu_torch.tools import demo

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(dtrenderer_tpu_torch.__file__))
    if here != os.path.join(os.path.abspath(root), "dtrenderer_tpu_torch"):
        raise AssertionError(f"imported {here}, not {root}'s package")
    mods = [importlib.import_module(f"dtrenderer_tpu_torch.kernels.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__)]
    with cf.ThreadPoolExecutor(len(mods)) as ex:
        list(ex.map(lambda m: m.library(), mods))
    dev = torch.device(DEVICE)
    frame = demo.ApiFrame(1920, 1080, dev)
    times = []
    for i in range(6):
        _, ms = timed(lambda: api.finish_frame(frame.update(
            api.new_state(1920, 1080, device=dev), 0.6)))
        times.append(ms)
    out = verb_times(frame, card_line())
    print(json.dumps({"root": root, "frame_ms": [round(t, 4) for t in times],
                      "verbs": out}))
    return 0


def verbs_against(card, parent: str):
    """--verbs-against DIR: verb_times of the checkout at DIR and of this
    tree in turns (parent, this, this, parent), each in a process of its
    own (both packages are dtrenderer_tpu_torch)."""
    for side, root in (("parent", parent), ("this", REPO), ("this", REPO),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--verb-times", root], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"verb times of {root} failed:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(f"verbs of the {side} tree ({root}):")
        print(res.stdout.strip().splitlines()[-3].split("]: ", 1)[1])
        print(res.stdout.strip().splitlines()[-2].split("]: ", 1)[1])
        print(res.stdout.strip().splitlines()[-1])
    print(f"verbs against {parent}: done [{card}]")


# ---------------------------------------------------------- stage breakdown


def host_ops(fn) -> int:
    """The ATen operations the host dispatches while fn() runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        fn()
    return ops.n


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stages_fused(spec, card):
    """One fused frame's stages (vertex stage + packing, binning, K1 and the
    torch merge, as the bench splits them), host clock up to a synchronise;
    beside them K1 with the merge in its epilogue, the draw call's path."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops import render_fused as rf

    fb = fblib.create(spec.height, spec.width, torch.device(DEVICE))
    (sub, batch), t_vert = timed(lambda: pack_submission(spec))
    bins, t_bin = timed(lambda: bin_batch(batch, spec.height, spec.width))
    args = (batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            spec.height, spec.width)
    (z, src, _), t_k = timed(lambda: rf.render_fused(*args))
    _, t_merge = timed(lambda: rf.merge_plain(fb, z, src))
    _, t_km = timed(lambda: rf.render_fused(*args, fb=fb))
    print(f"{spec.name} fused stages (ms): vertex+pack {t_vert:.3f}, binning "
          f"{t_bin:.3f}, render_fused {t_k:.3f}, merge {t_merge:.3f}; "
          f"render_fused with the merge {t_km:.3f} [{card}]")


def stage_draw(spec, sub, d, route="pallas"):
    """The vertex stage of one draw of a scene on `route`:
    pipeline.stage_draw_mesh ("pallas", "ref") or stage_draw_mesh_ordered
    ("scan")."""
    import torch

    from dtrenderer_tpu_torch.ops import pipeline

    args = (torch.device(DEVICE), d.mesh, d.model, sub.view_proj,
            spec.height, spec.width)
    kw = dict(texture=d.texture, light=sub.light, color=d.color,
              shading=d.shading, sampling_mode=sub.sampling_mode,
              near_clip=sub.near_clip)
    if route == "scan":
        return pipeline.stage_draw_mesh_ordered(*args, engine="scan", **kw)
    return pipeline.stage_draw_mesh(*args, backend=route, **kw)


def prepare_draw_of(spec, sub, d):
    """pipeline.prepare_draw of the same draw: the per-draw vertex stage in
    plain torch that stage_draw_mesh replaced on "pallas" and "ref"."""
    from dtrenderer_tpu_torch.ops import pipeline
    from dtrenderer_tpu_torch.utils.math3d import mat4mul

    return pipeline.prepare_draw(
        d.mesh, d.model, sub.view_proj, mat4mul(sub.view_proj, d.model),
        d.model, sub.light, d.color, d.shading, spec.width, spec.height, True,
        sub.near_clip)


def stages_pallas(spec, card):
    """One backend="pallas" draw's stages (vertex stage = stage_draw_mesh,
    binning, K2, shade_deferred), per draw of the scene, with prepare_draw
    of the same draws timed beside the vertex stage."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline
    from dtrenderer_tpu_torch.ops import raster_pallas as rp

    fb = fblib.create(spec.height, spec.width, torch.device(DEVICE))
    sub = spec.submission(0.5)
    tot = [0.0] * 5
    for d in sub.draws:
        staged, t_vert = timed(lambda: stage_draw(spec, sub, d))
        _, t_prep = timed(lambda: prepare_draw_of(spec, sub, d))
        setup = staged.setup
        bins, t_bin = timed(lambda: bin_batch(setup, spec.height,
                                              spec.width))
        (z, tri), t_k = timed(lambda: rp.rasterize_bins(
            setup.coef, bins, spec.height, spec.width))
        fb, t_sh = timed(lambda: pipeline.shade_deferred(
            fb, z, tri, setup.coef, staged.attrs10, staged.texture,
            staged.sampling_mode, staged.shading, staged.light))
        tot = [a + b for a, b in zip(tot, (t_vert, t_bin, t_k, t_sh,
                                           t_prep))]
    print(f"{spec.name} pallas stages (ms, {len(sub.draws)} draw(s)): vertex "
          f"{tot[0]:.3f} (stage_draw_mesh; prepare_draw {tot[4]:.3f}), "
          f"binning {tot[1]:.3f}, rasterize_bins {tot[2]:.3f}, "
          f"shade_deferred {tot[3]:.3f} [{card}]")


def staging_vs_prepare_draw(card, cfg4p, cfg5p, reps: int = 10):
    """The vertex stage of "pallas", "ref" and "scan" (one eager
    vertex_batch.pack, one VP launch) against prepare_draw on the card, at
    config 5 on "pallas" and at config 4's four draws on all three routes:
    setup.coef, bbox, valid and attrs10 bit-equal (NaN at the same places);
    one VP launch a staging and no vertex graph sighting; attrs10 handed to
    DS without a copy. Then per scene on "pallas" the stage against
    prepare_draw and against plan_run alone (the pass's host-side plan,
    made anew every staging): ATen ops the host dispatches a call and
    median ms on the host clock to a synchronise."""
    import numpy as np
    import torch

    from dtrenderer_tpu_torch.ops import pipeline, vertex_batch
    from dtrenderer_tpu_torch.ops import vertex_graph

    dev = torch.device(DEVICE)

    def sightings():
        return (vertex_graph.EAGER, vertex_graph.CAPTURES,
                vertex_graph.REPLAYS)

    def plan(spec, sub, d):
        return vertex_batch.plan_run(
            [pipeline.DrawSpec(d.mesh, d.model, color=d.color,
                               shading=d.shading)], sub.sampling_mode,
            spec.width, spec.height, True, sub.near_clip, False, dev)

    for spec, routes in ((cfg5p, ("pallas",)),
                         (cfg4p, ("pallas", "ref", "scan"))):
        sub = spec.submission(0.5)
        for i, d in enumerate(sub.draws):
            want_setup, want_attrs = prepare_draw_of(spec, sub, d)
            for route in routes:
                tag = f"staging vs prepare_draw {spec.name} draw {i} {route}"
                reset_counts()  # sets vertex_graph.REPLAYS to 0
                graph = sightings()
                staged = stage_draw(spec, sub, d, route)
                torch.cuda.synchronize()
                got = read_counts()
                if got != {"K1": 0, "K2": 0, "K3": 0, "VP": 1, "BN": 0,
                           "DS": 0, "D2": 0} or sightings() != graph:
                    raise AssertionError(
                        f"{tag}: launches {got}, vertex graph (eager, "
                        f"captures, replays) {graph} -> {sightings()}")
                n_nan = 0
                for name, a, b in (
                        ("coef", staged.setup.coef, want_setup.coef),
                        ("bbox", staged.setup.bbox, want_setup.bbox),
                        ("valid", staged.setup.valid, want_setup.valid),
                        ("attrs10", staged.attrs10, want_attrs)):
                    n_nan += same_bits_nan(f"{tag}: {name}", a, b)
                rows = staged.setup.coef.shape[0]
                if pipeline._attrs_rows(staged.attrs10, rows, dev) \
                        is not staged.attrs10:
                    raise AssertionError(f"{tag}: DS would copy attrs10")
                print(f"{tag}: setup.coef, bbox, valid and attrs10 bit-equal "
                      f"({rows} rows, {n_nan} NaN values at the same "
                      f"places), VP 1 launch, vertex graph untouched, "
                      f"attrs10 row stride {staged.attrs10.stride(0)} read "
                      f"by DS in place")
        ops = {name: sum(host_ops(lambda: fn(spec, sub, d))
                         for d in sub.draws)
               for name, fn in (("stage", stage_draw),
                                ("prepare_draw", prepare_draw_of),
                                ("plan_run", plan))}
        ms = {name: [] for name in ops}
        for name in ("stage", "prepare_draw", "plan_run", "plan_run",
                     "prepare_draw", "stage"):
            fn = {"stage": stage_draw, "prepare_draw": prepare_draw_of,
                  "plan_run": plan}[name]
            ms[name] += [timed(lambda: [fn(spec, sub, d)
                                        for d in sub.draws])[1]
                         for _ in range(reps // 2)]
        med = {k: round(float(np.median(v)), 4) for k, v in ms.items()}
        print(f"staging vs prepare_draw {spec.name} ({len(sub.draws)} "
              f"draw(s) a frame): host ops a frame {json.dumps(ops)}; ms a "
              f"frame, host clock to a synchronise (median of {reps}) "
              f"{json.dumps(med)}; plan_run's share of the stage "
              f"{med['plan_run'] / med['stage']:.2f} [{card}]")


def abs_err(got, want) -> tuple:
    """(max |got - want| as a float, the elements whose bits differ) over
    the elements where neither is NaN; an equal pair counts 0 (equal
    infinities too)."""
    import torch

    a, b = got.contiguous(), want.contiguous()
    if a.dtype == torch.float32:
        ok = ~(torch.isnan(a) | torch.isnan(b))
        bits_a, bits_b = a.view(torch.int32), b.view(torch.int32)
    else:
        ok = torch.ones_like(a, dtype=torch.bool)
        bits_a, bits_b = a, b
    d = torch.where((a == b) | ~ok, 0.0, (a.double() - b.double()).abs())
    n = int(((bits_a != bits_b) & ok).sum())
    return (float(d.max()) if d.numel() else 0.0), n


def same_bits_nan(tag, got, want) -> int:
    """got and want equal bit for bit, a float NaN at the same places (any
    NaN); returns the NaN values."""
    import torch

    a, b = got.contiguous(), want.contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tag}: {a.dtype} {tuple(a.shape)} vs "
                             f"{b.dtype} {tuple(b.shape)}")
    if a.dtype != torch.float32:
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: differs at "
                                 f"{int((a != b).sum())} elements")
        return 0
    nan = torch.isnan(b)
    if not torch.equal(torch.isnan(a), nan):
        raise AssertionError(f"{tag}: NaN at other places")
    ai = torch.where(nan, 0, a.view(torch.int32))
    bi = torch.where(nan, 0, b.view(torch.int32))
    if not torch.equal(ai, bi):
        raise AssertionError(f"{tag}: differs at {int((ai != bi).sum())} "
                             f"elements")
    return int(nan.sum())


def stages_ordered(scene, card):
    """One ordered frame's stages (vertex stage + packing, binning, K3)."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops import raster_ordered as ro

    fb = fblib.create(scene.height, scene.width, torch.device(DEVICE))
    (sub, batch), t_vert = timed(lambda: pack_submission(scene))
    bins, t_bin = timed(lambda: bin_batch(batch, scene.height, scene.width))
    _, t_k = timed(lambda: ro.render_ordered_bins(
        batch.coef, batch.payload, bins, batch.tex_lut, sub.light, fb.color,
        fb.depth, scene.height, scene.width))
    print(f"{scene.name} ordered stages (ms): vertex+pack {t_vert:.3f}, "
          f"binning {t_bin:.3f}, render_ordered_bins {t_k:.3f} [{card}]")


# -------------------------------------------------------------- band paths


def bits_equal(tag, got, want):
    """Colour and depth of two framebuffers bit-equal (on the card)."""
    import torch

    for name in ("depth", "color"):
        a = getattr(got, name).view(torch.int32)
        b = getattr(want, name).to(a.device).view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the "
                                 f"single-launch frame at "
                                 f"{int((a != b).sum())} elements")


def counted(tag, want: dict, total: dict, fn):
    """fn() with every launch count set to 0 just before and read just
    after; the counts must equal `want` and are added to `total`."""
    reset_counts()
    out = fn()
    got = read_counts()
    if not launches_ok(got, want):
        raise AssertionError(f"{tag}: kernel launches {got}, want {want}")
    for k, n in got.items():
        total[k] += n
    return out


def timed_frames(fn, n: int):
    """(last result, [ms]) of n calls, host clock to a synchronise."""
    out, times = None, []
    for _ in range(n):
        out, ms = timed(fn)
        times.append(ms)
    return out, times


def ms_list(times) -> str:
    return f"{', '.join(f'{t:.3f}' for t in times)} (best {min(times):.3f})"


def same_pairs(tag, got, want, n_tris: int):
    """Two lists of per-band Bins hold the same (tile, triangle) pairs: per
    band the same per-tile counts and the same ids in the same order, which
    ascend within every tile."""
    import torch

    from dtrenderer_tpu_torch.ops import binning

    n_pairs = 0
    for b, (x, y) in enumerate(zip(got, want)):
        cx = x.tile_start[1:] - x.tile_start[:-1]
        cy = y.tile_start[1:] - y.tile_start[:-1]
        ids = binning.window_ids(x)
        if not (torch.equal(cx, cy)
                and torch.equal(ids, binning.window_ids(y))):
            raise AssertionError(f"{tag}: band {b}'s kept pairs differ")
        tile = torch.repeat_interleave(
            torch.arange(cx.numel(), device=cx.device), cx.long())
        key = tile * n_tris + ids.long()
        if not bool((key[1:] > key[:-1]).all()):
            raise AssertionError(f"{tag}: band {b}'s ids do not ascend")
        n_pairs += ids.numel()
    return n_pairs


def band_paths(card, cfg4, cfg5, sphere) -> dict:
    """The band split of a frame over a mesh of devices (parallel/shard.py)
    at full size, every cell on one of this machine's cards, cycled; every
    path with the launch counts set to 0 just before and read just after,
    and bit-equal to its single-launch frame. Returns the summed launches."""
    import torch

    from dtrenderer_tpu_torch.kernels import render_fused as k1
    from dtrenderer_tpu_torch.models import scenes
    from dtrenderer_tpu_torch.ops import binning, fb as fblib, pipeline
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.parallel import shard
    from dtrenderer_tpu_torch.tools import dryrun
    from dtrenderer_tpu_torch.utils.benchlib import device_time

    dev = torch.device(DEVICE)
    total = {"K1": 0, "K2": 0, "K3": 0, "VP": 0, "BN": 0, "DS": 0, "D2": 0}
    rows = 8
    mesh8 = shard.make_mesh(frames=1, rows=rows)
    mesh42 = shard.make_mesh(frames=1, rows=4, cols=2)
    print(f"band paths: meshes 1x8x1 and 1x4x2 over "
          f"{torch.cuda.device_count()} card(s), cycled: "
          f"{[str(d) for d in mesh8.devices.reshape(-1)]} [{card}]")

    # ---- config 5: 3840x2160, 1,000,000 triangles, 8 bands of 270 rows
    h, w = cfg5.height, cfg5.width
    sub = cfg5.submission(0.5)
    d = sub.draws[0]
    kw = dict(texture=d.texture, light=sub.light, color=d.color,
              shading=d.shading, sampling_mode=sub.sampling_mode,
              near_clip=sub.near_clip)
    fb5 = fblib.clear(fblib.create(h, w, dev), [0.02, 0.02, 0.04, 1.0])
    cut5 = shard.shard_fb(fb5, mesh8)
    ways = [("per band", None), ("shared", dict(row_bands=rows)),
            ("distributed", dict(row_bands=rows, band_distributed=True))]

    single = {}
    for backend, key in (("fused", "K1"), ("pallas", "K2")):
        want = {"K1": 0, "K2": 0, "K3": 0, key: 2, "VP": 2, "BN": 2,
                "DS": 0 if backend == "fused" else 2}
        single[backend], times = counted(
            f"config 5 {backend} single launch", want, total,
            lambda: timed_frames(lambda: pipeline.draw_mesh(
                fb5, d.mesh, d.model, sub.view_proj, backend=backend, **kw),
                2))
        print(f"band paths: config 5 {w}x{h} {backend}, one draw_mesh on the "
              f"whole frame: ms {ms_list(times)} [{card}]")

    def sharded5(backend, opts):
        out = shard.draw_mesh_sharded(cut5, d.mesh, d.model, sub.view_proj,
                                      mesh8, backend=backend,
                                      raster_opts=opts, **kw)
        return shard.gather_fb(out, dev)

    # binning.bin_triangles calls a frame: one per band, one table per
    # distinct card of the mesh, none for the exchange
    tables = {"per band": rows, "shared": len(mesh8.distinct()),
              "distributed": 0}
    for way, opts in ways:
        got, times = counted(
            f"config 5 fused, {rows} bands, {way}",
            {"K1": 2 * rows, "K2": 0, "K3": 0, "VP": 2,
             "BN": 2 * tables[way], "DS": 0}, total,
            lambda: timed_frames(lambda: sharded5("fused", opts), 2))
        bits_equal(f"config 5 fused, {rows} bands, {way}", got,
                   single["fused"])
        print(f"band paths: config 5 fused, {rows} bands of {h // rows} "
              f"rows, {way} binning: z and colour bit-equal to the single "
              f"launch, K1 {rows} launches a frame, ms {ms_list(times)} "
              f"(draw_mesh_sharded + gather_fb) [{card}]")
    # the same three ways through draw_mesh on the whole framebuffer
    for way, opts in ways[1:] + [("per band", dict(row_bands=rows,
                                                   band_shared=False))]:
        got, times = counted(
            f"config 5 draw_mesh row_bands, {way}",
            {"K1": rows, "K2": 0, "K3": 0, "VP": 1,
             "BN": {"shared": 1, "distributed": 0, "per band": rows}[way],
             "DS": 0},
            total,
            lambda: timed_frames(lambda: pipeline.draw_mesh(
                fb5, d.mesh, d.model, sub.view_proj, backend="fused",
                raster_opts=opts, **kw), 1))
        bits_equal(f"config 5 draw_mesh row_bands, {way}", got,
                   single["fused"])
        print(f"band paths: config 5 draw_mesh(raster_opts row_bands={rows}, "
              f"{way}) on the whole framebuffer: bit-equal, K1 {rows} "
              f"launches, ms {ms_list(times)} [{card}]")

    # benchlib.device_time: CUDA events around a loop of calls (the host's
    # pace counts where it outlasts the card's)
    iters = 5
    per_call = counted(
        "config 5 row_bands shared, device_time",
        {"K1": rows * (iters + 1), "K2": 0, "K3": 0, "VP": iters + 1,
         "BN": iters + 1, "DS": 0}, total,
        lambda: device_time(lambda: pipeline.draw_mesh(
            fb5, d.mesh, d.model, sub.view_proj, backend="fused",
            raster_opts=ways[1][1], **kw), device=fb5.depth.device,
            iters=iters, warmup_iters=1))
    whole_call = counted(
        "config 5 single launch, device_time",
        {"K1": iters + 1, "K2": 0, "K3": 0, "VP": iters + 1,
         "BN": iters + 1, "DS": 0}, total,
        lambda: device_time(lambda: pipeline.draw_mesh(
            fb5, d.mesh, d.model, sub.view_proj, backend="fused", **kw),
            device=fb5.depth.device, iters=iters, warmup_iters=1))
    print(f"band paths: config 5 fused, benchlib.device_time over {iters} "
          f"back-to-back calls (CUDA events): draw_mesh row_bands={rows} "
          f"shared {per_call * 1e3:.3f} ms a call, single launch "
          f"{whole_call * 1e3:.3f} ms a call [{card}]")

    got, times = counted(
        f"config 5 pallas, {rows} bands",
        {"K1": 0, "K2": 2 * rows, "K3": 0,
         "VP": 2 * len(mesh8.distinct()), "BN": 2 * rows, "DS": 2 * rows},
        total,
        lambda: timed_frames(lambda: sharded5("pallas", None), 2))
    bits_equal(f"config 5 pallas, {rows} bands", got, single["pallas"])
    print(f"band paths: config 5 pallas, {rows} bands, per band binning: z "
          f"and colour bit-equal to the single launch, K2 {rows} launches a "
          f"frame, ms {ms_list(times)} [{card}]")

    # ---- the three ways of binning, alone, and their kept pairs
    _, batch = pack_submission(cfg5)
    n_tris = batch.coef.shape[0]
    args = (batch.coef, batch.bbox, batch.valid, h, w)
    whole_bins, t_whole = timed_frames(lambda: bin_batch(batch, h, w), 3)
    bands_of = {}
    for way, bkw in (("per band", dict(shared=False)), ("shared", {}),
                     ("distributed", dict(distributed=True))):
        bands_of[way], times = timed_frames(lambda: binning.bin_bands(
            *args, rows, 0, 0, rf.TILE_H, rf.TILE_W, **bkw), 3)
        print(f"band paths: config 5 binning alone, {rows} bands, {way}: ms "
              f"{ms_list(times)} (whole frame, one bin_triangles: "
              f"{ms_list(t_whole)}) [{card}]")
    n_pairs = same_pairs("per band vs shared", bands_of["per band"],
                         bands_of["shared"], n_tris)
    same_pairs("distributed vs shared", bands_of["distributed"],
               bands_of["shared"], n_tris)
    print(f"band paths: config 5 kept pairs equal per tile, ids ascending, "
          f"per band = shared = distributed: {n_pairs} pairs over the banded "
          f"grid ({whole_bins.tri_ids.shape[0]} over the whole frame's)")

    # ---- K1: the eight band launches back to back against the one
    scal = rf.light_scalars(sub.light)
    z = torch.empty((h, w), dtype=torch.float32, device=dev)
    src = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    bh = h // rows

    def band_launches():
        for b, bins in enumerate(bands_of["shared"]):
            ys = slice(b * bh, (b + 1) * bh)
            k1.launch(batch.coef, batch.payload, bins.tile_start,
                      bins.tri_ids, batch.tex_lut, scal, z[ys], src[ys], bh,
                      w, b * bh, 0)

    loop8 = (cuda_ms(band_launches, 50), cuda_ms(band_launches, 50))
    torch.cuda.synchronize()
    if not (torch.equal(z.view(torch.int32),
                        single["fused"].depth.view(torch.int32))):
        raise AssertionError("K1 band launches: z differs from the frame's")
    loop1 = launch_loop_ms(lambda: k1.launch(
        batch.coef, batch.payload, whole_bins.tile_start, whole_bins.tri_ids,
        batch.tex_lut, scal, z, src, h, w, 0, 0), 50)
    print(f"band paths: K1 config 5 launch loop, {rows} band launches "
          f"together {loop8[0]:.4f}, {loop8[1]:.4f} ms; one whole-frame "
          f"launch {loop1[0]:.4f}, {loop1[1]:.4f} ms [{card}]")

    # ---- config 4 through render_frames_sharded, cfg4.frame's band
    # arguments, 4 x 2 tiles of 270 x 960 (one scene per distinct card)
    h4, w4 = cfg4.height, cfg4.width
    frame_on = {dd: (cfg4 if dd == dev else
                     scenes.make_config4(device=dd)).frame
                for dd in mesh42.distinct()}

    def band_fn(band_fb, t, y0, fh, fw, x0):
        return frame_on[band_fb.depth.device](
            band_fb.color, band_fb.depth, t, y_offset=y0, frame_height=fh,
            frame_width=fw, x_offset=x0)

    fb4 = fblib.create(h4, w4, dev)
    t4 = torch.tensor([0.5])  # one frame: a batch of one time
    want4 = fblib.Framebuffer(*cfg4.frame(fb4.color, fb4.depth, 0.5))
    cut4 = shard.create_sharded_fb(h4, w4, mesh42, batch=1)
    got, times = counted(
        "config 4, 4 x 2 tiles",
        {"K1": 2 * 8, "K2": 0, "K3": 0, "VP": 2, "BN": 2 * 8, "DS": 0},
        total,
        lambda: timed_frames(lambda: shard.gather_fb(
            shard.render_frames_sharded(band_fn, cut4, mesh42, t4), dev),
            2))
    bits_equal("config 4, 4 x 2 tiles",
               fblib.Framebuffer(got.color[0], got.depth[0]), want4)
    print(f"band paths: config 4 {w4}x{h4} through render_frames_sharded, "
          f"4 x 2 tiles of {h4 // 4}x{w4 // 2}: bit-equal to the whole "
          f"frame, K1 8 launches a frame, ms {ms_list(times)} [{card}]")

    # ---- the translucent sphere, 8 bands of 135 rows
    hs, ws = sphere.height, sphere.width
    subs = sphere.submission(0.5)
    ds = subs.draws[0]
    kws = dict(light=subs.light, color=ds.color, shading=ds.shading)
    fbs = fblib.clear(fblib.create(hs, ws, dev), [0.02, 0.02, 0.05, 1.0])
    cuts = shard.shard_fb(fbs, mesh8)
    want_s, t_one = counted(
        "sphere single launch",
        {"K1": 0, "K2": 0, "K3": 2, "VP": 2, "BN": 2, "DS": 0}, total,
        lambda: timed_frames(lambda: pipeline.draw_mesh_ordered(
            fbs, ds.mesh, ds.model, subs.view_proj, **kws), 2))
    got, times = counted(
        f"sphere, {rows} bands",
        {"K1": 0, "K2": 0, "K3": 2 * rows, "VP": 2, "BN": 2 * rows,
         "DS": 0}, total,
        lambda: timed_frames(lambda: shard.gather_fb(
            shard.draw_mesh_ordered_sharded(
                cuts, ds.mesh, ds.model, subs.view_proj, mesh8, **kws), dev),
            2))
    bits_equal(f"sphere, {rows} bands", got, want_s)
    print(f"band paths: translucent sphere {ws}x{hs}, {rows} bands of "
          f"{hs // rows} rows: colour and depth bit-equal to the single "
          f"launch, K3 {rows} launches a frame, ms {ms_list(times)} (one "
          f"draw_mesh_ordered: {ms_list(t_one)}) [{card}]")

    # ---- the dry run over 8 cells, in-process (its launches are not a
    # path's: counted apart)
    _, ms = timed(lambda: dryrun.dryrun_multichip(rows))
    print(f"band paths: tools.dryrun over {rows} cells: {ms:.1f} ms "
          f"[{card}]")
    print(f"band paths: kernel launches {total}")
    return total


# ------------------------------------------------- vertex kernel vs twin

# float32 operations of the vertex kernel, counted from csrc/vertex_pass.cu
# (an upper count; the bytes bound it by far):
VP_CORNER_OPS = 56   # clip position 24; the mode's columns: normal 15 and
                     # light 17 (Gouraud), the most of the four modes
VP_ROW_OPS = 130     # viewport 30, edges and area 22, sign 10, 1/area,
                     # fill rule 12, bbox 20, q-premultiplied corners 27, ...
VP_CLIP_OPS = 135    # three intersections: 2 sub, 1 div, clamp, 13 lerps


def api_submission_fn(dev):
    """The API frame's render_meshes run at time t (tools/demo.py)."""
    import numpy as np

    from dtrenderer_tpu_torch.models import primitives
    from dtrenderer_tpu_torch.models.scenes import Submission
    from dtrenderer_tpu_torch.tools import demo

    cube = primitives.cube(device=dev)
    ball = primitives.uv_sphere(24, 32, device=dev)
    tex = primitives.checkerboard(64, 8, (1.0, 0.85, 0.3, 1.0),
                                  (0.15, 0.15, 0.5, 1.0), device=dev)
    grad = primitives.gradient_texture(64, device=dev)

    def submission(t):
        proj, light, draws = demo.demo_draws(np.float32(t), 1920, 1080, cube,
                                             ball, tex, grad, dev)
        return Submission(proj, draws, light, "bilinear", True)

    return submission


def same_batch_nan(tag, got, want) -> int:
    """Two DrawBatches bit-equal, every row (f32 as int32 bit patterns; a
    NaN may be any NaN, at the same places). Returns the NaN count."""
    return sum(same_bits_nan(f"{tag}: {name} against the plain pass", a, b)
               for name, a, b in zip(("coef", "bbox", "valid", "payload",
                                      "tex_lut"), got, want))


def vertex_kernel_vs_plain(card, cfg4, cfg5, sphere) -> dict:
    """csrc/vertex_pass.cu (vertex_batch.run_pass on the card) against
    run_pass_plain on the same plan and frame vector, every DrawBatch field
    bit for bit, invalid rows included (NaN at the same places): the bench
    cells' runs (fill, config 4, soup, config 5, the translucent sphere, the
    API frame's render_meshes run), config 4 with the translucent sphere
    between its opaque runs, config 4 with near clip off and culling off,
    every case of models/edge_cases.py and the shapes of models/stress.py
    in the four shading modes. The cells' runs are timed: the kernel's
    ctypes entry in a loop of 200 launches, run_pass (kernel) against
    run_pass_plain (plain, kernel, kernel, plain), and the bound by bytes
    (faces and the vertex arrays the modes read, each distinct tensor once,
    the frame vector and the table in; coef, bbox, valid, payload out).
    Returns per cell (0, run_pass ms, plain ms, bound, loop readings)."""
    import torch

    from bench_torch import scenes as bench_scenes
    from dtrenderer_tpu_torch.kernels import vertex_pass as kv
    from dtrenderer_tpu_torch.models import edge_cases as ec, stress
    from dtrenderer_tpu_torch.ops import vertex_batch as vb
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec
    from dtrenderer_tpu_torch.ops.shading import make_light

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    # (tag, draws, view_proj, light, sampling, w, h, cull, near, timed)
    runs = []
    for name, spec in (
            ("fill_six_spheres_1080p", bench_scenes.fill_scene(device=dev)),
            ("config4_1080p", cfg4),
            ("soup_200k_1080p", bench_scenes.soup_scene(device=dev)),
            ("config5_4k_1m", cfg5), ("ordered_sphere_1080p", sphere),
            ("api_frame_1080p", None)):
        w, h = (1920, 1080) if spec is None else (spec.width, spec.height)
        sub = (api_submission_fn(dev) if spec is None else spec.submission)(
            0.5)
        runs.append((name, sub.draws, sub.view_proj, sub.light,
                     sub.sampling_mode, w, h, True, sub.near_clip, True))
    sub4 = cfg4.submission(0.5)
    head, cube, ball, ball2 = sub4.draws
    trans = DrawSpec(ball.mesh, ball.model, color=(0.8, 0.5, 0.9, 0.6),
                     shading="phong")
    base4 = (sub4.view_proj, sub4.light, sub4.sampling_mode, cfg4.width,
             cfg4.height)
    for tag, draws in (("[head, cube]", [head, cube]),
                       ("translucent sphere", [trans]),
                       ("[sphere 2]", [ball2])):
        runs.append((f"mixed_config4 {tag}", draws, *base4, True, True,
                     False))
    runs.append(("config4 near clip off", sub4.draws, *base4, True, False,
                 False))
    runs.append(("config4 culling off", sub4.draws, *base4, False, True,
                 False))
    light = make_light(*ec.LIGHT, device=dev)
    for make in ec.CASES.values():
        c = make()
        runs.append((f"edge case {c.name!r}", ec.draw_specs(c, dev),
                     torch.from_numpy(c.view_proj).to(dev), light, "nearest",
                     c.width, c.height, c.cull_backfaces, c.near_clip, False))
    eye = torch.eye(4, device=dev)
    for sname, make in stress.CASES.items():
        corners, h, w = make()
        mesh = stress.mesh_of_corners(corners, h, w, dev)
        for mode in ("flat", "gouraud", "phong", "none"):
            runs.append((f"stress {sname} {mode}",
                         [DrawSpec(mesh, eye, shading=mode,
                                   color=(0.9, 0.6, 0.3, 1.0))],
                         eye, light, "nearest", w, h, False, True, False))

    out = {}
    for tag, draws, view_proj, lt, sampling, w, h, cull, near, timed in runs:
        plan = vb.plan_run(draws, sampling, w, h, cull, near, False, dev)
        vec = vb.frame_vector(plan, draws, view_proj, lt)
        got = vb.run_pass(plan, vec, draws)
        want = vb.run_pass_plain(plan, vec, draws)
        torch.cuda.synchronize()
        n_nan = same_batch_nan(f"vertex kernel {tag}", got, want)
        line = (f"vertex kernel vs plain, {tag} {w}x{h}: {plan.n_draws} "
                f"draw(s), {plan.n_rows} setup rows, {int(got.valid.sum())} "
                f"valid, NaN {n_nan}: bit-equal")
        if not timed:
            print(line)
            continue
        mvps = vb._mvps(plan, vec[:16 * plan.n_mats].view(plan.n_mats, 4,
                                                         4)).contiguous()
        outs = [torch.empty_like(x) for x in got[:4]]
        loop = launch_loop_ms(lambda: kv.launch(
            plan.table, plan.heads, vec, mvps, *outs, plan.n_tris,
            plan.light_at, w, h, cull, near))
        torch.cuda.synchronize()
        same_batch_nan(f"vertex kernel {tag}, launch loop",
                       [*outs, got.tex_lut], got)
        k_ms, p_ms, r = interleaved_ms(lambda: vb.run_pass(plan, vec, draws),
                                       lambda: vb.run_pass_plain(plan, vec,
                                                                 draws), 20)
        inputs = {}
        for d in draws:
            names = ["faces", "verts", "uv"]
            if d.shading in ("gouraud", "phong"):
                names.append("normals")
            for n in names:
                t = getattr(d.mesh, n)
                inputs[(t.data_ptr(), n)] = t
        n_bytes = nbytes(*inputs.values(), vec, plan.table, plan.heads,
                         *got[:4])
        ops = plan.n_tris * (3 * VP_CORNER_OPS + (
            VP_CLIP_OPS + 2 * VP_ROW_OPS if near else VP_ROW_OPS))
        b = bound(n_bytes, ops)
        print(f"{line}; kernel loop of 200 {loop[0]:.4f}, {loop[1]:.4f} ms, "
              f"run_pass {k_ms:.4f} ms ({r[1]:.4f}, {r[2]:.4f}), plain "
              f"{p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), bound "
              f"{b[0]:.4f} ms by {b[1]} ({n_bytes} bytes, {ops} f32 ops), "
              f"loop / bound {min(loop) / b[0]:.2f} [{card}]")
        out[tag] = (0.0, k_ms, p_ms, b, loop)
    print(f"vertex kernel vs plain: {len(runs)} runs bit-equal, "
          f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------- binning kernel vs twin


def host_syncs(fn) -> int:
    """Host synchronisations fn() makes, counted under torch's sync debug
    mode (one warning per synchronising call)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def same_bins(tag, got, want):
    """Two Bins bit-equal: tile_start, tri_ids, overflow."""
    import torch

    for name in ("tile_start", "tri_ids", "overflow"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.shape != b.shape or \
                not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the plain "
                                 f"path")


def binning_runs(dev, cfg4, cfg5, sphere) -> list:
    """The binning phase's inputs: (tag, coef, bbox, valid, height, width,
    y0, x0, bands, timed), the main paths' inputs (timed) first, then the
    stress shapes in their windows and every edge case."""
    import torch

    from bench_torch import scenes as bench_scenes
    from dtrenderer_tpu_torch.models import edge_cases as ec, stress
    from dtrenderer_tpu_torch.ops import pipeline
    from dtrenderer_tpu_torch.ops.shading import make_light

    runs = []
    for name, spec, bands in (
            ("config5_4k_1m", cfg5, 1), ("config5_4k_bands8_shared", cfg5, 8),
            ("soup_200k_1080p", bench_scenes.soup_scene(device=dev), 1),
            ("fill_six_spheres_1080p", bench_scenes.fill_scene(device=dev),
             1),
            ("config4_1080p", cfg4, 1), ("ordered_sphere_1080p", sphere, 1),
            ("api_frame_1080p", None, 1)):
        w, h = (1920, 1080) if spec is None else (spec.width, spec.height)
        sub = (api_submission_fn(dev) if spec is None else spec.submission)(
            0.5)
        batch = pipeline.pack_draws(sub.draws, sub.view_proj, sub.light,
                                    sub.sampling_mode, w, h,
                                    near_clip=sub.near_clip)
        runs.append((name, batch.coef, batch.bbox, batch.valid, h, w, 0, 0,
                     bands, True))
    for sname, make in stress.CASES.items():
        corners, h, w = make()
        setup = stress.setup(corners, h, w, dev)
        for y0, x0, bh, bw in stress.windows(h, w):
            runs.append((f"stress {sname} {bh}x{bw} at ({y0}, {x0})",
                         setup.coef, setup.bbox, setup.valid, bh, bw, y0, x0,
                         1, False))
    for make in ec.CASES.values():
        c = make()
        batch = pipeline.pack_draws(
            ec.draw_specs(c, dev), torch.from_numpy(c.view_proj).to(dev),
            make_light(*ec.LIGHT, device=dev), "nearest", c.width,
            c.height, c.cull_backfaces, c.near_clip)
        runs.append((f"edge case {c.name!r}", batch.coef, batch.bbox,
                     batch.valid, c.height, c.width, 0, 0, 1, False))
    return runs


def bin_passes(kb, bbox, valid, grid, n_tiles: int, n_pairs: int):
    """The device passes of one binning.bin_triangles call (csrc/binning.cu:
    the scan, then the emit, CUB's sort and the tile starts) on tensors
    allocated here, the pair count known (no host read). Returns (run,
    result): run() enqueues them, result() is (tile_start, tri_ids,
    overflow) of the last run."""
    import torch

    dev = bbox.device
    T = bbox.shape[0]
    work = torch.empty(T + 2 + -(-T // kb.budget()), dtype=torch.int64,
                       device=dev)
    scratch = torch.empty(kb.scratch_bytes(n_pairs, grid), dtype=torch.uint8,
                          device=dev)
    tile_start = torch.empty(n_tiles + 2, dtype=torch.int32, device=dev)
    tri_ids = torch.empty(n_pairs, dtype=torch.int32, device=dev)

    def run():
        kb.scan(bbox, valid, grid, work)
        kb.emit(bbox, valid, work, n_pairs, grid, scratch, tile_start,
                tri_ids)

    return run, lambda: (tile_start[:-1], tri_ids, tile_start[-1])


def bin_passes_per_pair(kb, bbox, valid, grid, n_tiles: int,
                        n_pairs: int):
    """bin_passes for the earlier design of csrc/binning.cu (a count, a
    torch.cumsum, one thread a pair with a binary search and an atomic
    count per tile, a torch.cumsum into tile_start, CUB's sort; entries
    cover, pairs and sort_pairs), for `python3 chip_smoke.py --bin-against
    DIR`."""
    import torch

    dev = bbox.device
    n_cover = torch.empty(bbox.shape[0], dtype=torch.int64, device=dev)
    tally = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    tile_of, tri_of, keys_out, tri_ids = (
        torch.empty(n_pairs, dtype=torch.int32, device=dev) for _ in range(4))
    end_bit = max(1, (n_tiles - 1).bit_length())
    out = {}

    def run():
        tally.zero_()
        kb.cover(bbox, valid, grid, n_cover)
        ends = torch.cumsum(n_cover, 0)
        kb.pairs(bbox, valid, ends, grid, tile_of, tri_of, tally)
        out["tile_start"] = torch.cumsum(tally, 0, dtype=torch.int32)
        kb.sort_pairs(tile_of, tri_of, keys_out, tri_ids, end_bit)

    return run, lambda: (out["tile_start"], tri_ids, None)


def graph_ms(run, reps: int = 200):
    """Two readings of `run` captured once in a CUDA graph and replayed
    `reps` times back to back: the card's time for the passes, without the
    host's enqueue."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return cuda_ms(graph.replay, reps), cuda_ms(graph.replay, reps)


def device_ops(fn) -> list:
    """(name, microseconds) of each device operation (kernel, memset, copy)
    one fn() (a binning call, which reads the pair count back) enqueues, in
    the order of the card, from torch.profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # the trace now and then loses a call's first ops
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if any(e.name.startswith("Memcpy DtoH") for e in ops):
            break  # the call's read of the pair count is in the trace
    return [(e.name, e.time_range.elapsed_us()) for e in ops]


def short_ops(ops) -> str:
    """A device-op list in a line: names cut at their '(' or '<', each with
    its microseconds."""
    cut = []
    for name, us in ops:
        head = name.replace("(anonymous namespace)::", "").split("(")[0]
        head = head.split("<")[0].strip().removeprefix("void ")
        cut.append(f"{(head or name).split('::')[-1]} {us:.1f}")
    return ", ".join(cut)


def binning_kernel_vs_plain(card, cfg4, cfg5, sphere) -> dict:
    """csrc/binning.cu (binning.bin_triangles on the card) against
    bin_triangles_plain on the same inputs, tile_start, tri_ids and overflow
    bit for bit: every main path's inputs (config 5, config 5 in 8 bands
    over the shared table, the soup, the fill scene, config 4, the
    translucent sphere, the API frame's render_meshes run), the stress
    shapes in their windows and every edge case. The main paths' inputs are
    timed: a loop of 200 device passes (bin_passes: the pair count known,
    no host read), the same passes captured once in a CUDA graph and
    replayed 200 times (the card's time), bin_triangles against
    bin_triangles_plain (plain, kernel, kernel, plain; each call with its
    read), the bound by bytes (bbox and valid in, tile_start and tri_ids
    out), the device operations a call (torch.profiler) and the host
    synchronisations a call. Returns per scene (0, call ms, plain ms,
    bound, syncs, plain syncs, pairs, device ops, graph readings, loop
    readings)."""
    import torch

    from dtrenderer_tpu_torch.kernels import binning as kb
    from dtrenderer_tpu_torch.ops import binning
    from dtrenderer_tpu_torch.ops import render_fused as rf

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    runs = binning_runs(dev, cfg4, cfg5, sphere)
    out = {}
    for tag, coef, bbox, valid, h, w, y0, x0, bands, timed in runs:
        args = (coef, bbox, valid, h, w, y0, x0, rf.TILE_H, rf.TILE_W, bands)
        got = binning.bin_triangles(*args)
        want = binning.bin_triangles_plain(*args)
        torch.cuda.synchronize()
        same_bins(f"binning kernel {tag}", got, want)
        n_pairs, n_tiles = got.tri_ids.shape[0], got.tile_start.shape[0] - 1
        counts = got.tile_start[1:] - got.tile_start[:-1]
        line = (f"binning kernel vs plain, {tag} {w}x{h}"
                f"{f' in {bands} bands' if bands > 1 else ''}: "
                f"{coef.shape[0]} triangles, {int(valid.sum())} valid, "
                f"{n_pairs} pairs over {n_tiles} tiles (deepest "
                f"{int(counts.max()) if n_tiles else 0}): bit-equal")
        if not timed:
            print(line)
            continue
        grid = (h, w, y0, x0, rf.TILE_H, rf.TILE_W, bands)
        run, result = bin_passes(kb, bbox, valid, grid, n_tiles, n_pairs)

        def same_as_call(how):
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(result(), got[:3])):
                raise AssertionError(f"binning kernel {tag}: the {how}'s "
                                     f"Bins differ from the call's")

        loop = launch_loop_ms(run)
        same_as_call("loop")
        graph = graph_ms(run)
        same_as_call("graph")
        k_ms, p_ms, r = interleaved_ms(lambda: binning.bin_triangles(*args),
                                       lambda: binning.bin_triangles_plain(
                                           *args), 20)
        syncs = host_syncs(lambda: binning.bin_triangles(*args))
        plain_syncs = host_syncs(lambda: binning.bin_triangles_plain(*args))
        if syncs != 1:
            raise AssertionError(f"binning kernel {tag}: {syncs} host "
                                 f"synchronisations a call, want 1")
        ops = device_ops(lambda: binning.bin_triangles(*args))
        n_bytes = nbytes(bbox, valid, got.tile_start, got.tri_ids)
        b = bound(n_bytes, 0)
        print(f"{line}; device passes, loop of 200 {loop[0]:.4f}, "
              f"{loop[1]:.4f} ms, graph replayed 200 times {graph[0]:.4f}, "
              f"{graph[1]:.4f} ms, bin_triangles {k_ms:.4f} ms ({r[1]:.4f}, "
              f"{r[2]:.4f}), plain {p_ms:.4f} ms ({r[0]:.4f}, {r[3]:.4f}), "
              f"bound {b[0]:.4f} ms by {b[1]} ({n_bytes} bytes), graph / "
              f"bound {min(graph) / b[0]:.1f}, host synchronisations a call "
              f"{syncs} (plain {plain_syncs}), device ops a call {len(ops)} "
              f"({short_ops(ops)}) [{card}]")
        out[tag] = (0.0, k_ms, p_ms, b, syncs, plain_syncs, n_pairs, len(ops),
                    graph, loop)
    print(f"binning kernel vs plain: {len(runs)} runs bit-equal, "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def binning_against_parent(card, parent: str, cfg4, cfg5, sphere):
    """The binning of the checkout at `parent` (its csrc/binning.cu and
    ops/binning.py, e.g. a git archive of the parent commit) against this
    tree's at the main paths' inputs, in turns (parent, this, this, parent)
    in one process: the loop of 200 device passes, the graph replayed 200 times,
    20 calls of bin_on_card with their read, and the device operations a
    call. Both Bins bit-equal to each other and to the plain path."""
    import importlib.util
    import types

    import torch

    from dtrenderer_tpu_torch import kernels
    from dtrenderer_tpu_torch.kernels import binning as kb
    from dtrenderer_tpu_torch.ops import binning
    from dtrenderer_tpu_torch.ops import render_fused as rf

    pkg = os.path.join(os.path.abspath(parent), "dtrenderer_tpu_torch")

    def module(name, rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    pkb = module("parent_kernels_binning", "kernels/binning.py")
    pkb.kernels = types.SimpleNamespace(load=lambda src: kernels.load(
        src, os.path.join(pkg, "csrc")))
    pbin = module("parent_ops_binning", "ops/binning.py")
    info = pkb.library()[1]
    print(f"parent binning.cu from {parent}: built in {info.seconds:.1f} s")
    dev = torch.device(DEVICE)
    for tag, coef, bbox, valid, h, w, y0, x0, bands, timed in binning_runs(
            dev, cfg4, cfg5, sphere):
        if not timed:
            continue
        grid = (h, w, y0, x0, rf.TILE_H, rf.TILE_W, bands)
        calls = {"parent": lambda: pbin.bin_on_card(bbox, valid, *grid, pkb),
                 "this": lambda: binning.bin_on_card(bbox, valid, *grid, kb)}
        want = binning.bin_triangles_plain(coef, bbox, valid, *grid)
        for side, call in calls.items():
            same_bins(f"binning {side} tree {tag}", call(), want)
        n_pairs, n_tiles = want.tri_ids.shape[0], want.tile_start.shape[0] - 1
        passes = bin_passes_per_pair if hasattr(pkb, "cover") else bin_passes
        runs = {"parent": passes(pkb, bbox, valid, grid, n_tiles,
                                 n_pairs)[0],
                "this": bin_passes(kb, bbox, valid, grid, n_tiles,
                                   n_pairs)[0]}
        order = ("parent", "this", "this", "parent")
        got = {k: [] for k in ("loop", "graph", "call")}
        for side in order:
            got["loop"].append(cuda_ms(runs[side], 200))
        for side in order:
            got["graph"].append(graph_ms(runs[side])[0])
        for side in order:
            got["call"].append(cuda_ms(calls[side], 20))
        ops = {side: device_ops(calls[side]) for side in calls}
        read = " ".join(
            f"{how} (parent, this, this, parent) "
            f"{', '.join(f'{v:.4f}' for v in vals)} ms;"
            for how, vals in got.items())
        print(f"binning {parent} vs this, {tag} ({n_pairs} pairs): {read} "
              f"device ops a call {len(ops['parent'])} "
              f"({short_ops(ops['parent'])}) -> {len(ops['this'])} "
              f"({short_ops(ops['this'])}) [{card}]")


# ------------------------------------------------------ vertex stage graph


def same_batch(tag, got, want):
    """Two DrawBatches bit-equal (f32 as int32 bit patterns)."""
    import torch

    for name, a, b in zip(("coef", "bbox", "valid", "payload", "tex_lut"),
                          got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the eager "
                                 f"pass")


def vertex_stage_graph(card, cfg4, cfg5, sphere):
    """The vertex stage's CUDA graph (ops/vertex_graph.py) against its
    eager pass, for the fill scene, config 4, the soup, config 5, the
    translucent sphere and the API frame's render_meshes run: bit-equal at
    t = 0.5 (first sighting eager, second captured, then replays), 0.3 and
    0.7; a mesh and a texture changed in place, seen by the next replay;
    two identical opaque runs around a translucent draw in one
    draw_meshes (config 5 on bands: band_graph_check). Counts the host's
    ops and times the stage
    (pack_draws of a ready submission), eager against replay, on the host
    clock and with CUDA events; the timed replays must all be replays."""
    from unittest import mock

    import numpy as np
    import torch

    from bench_torch import scenes as bench_scenes
    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline, vertex_batch
    from dtrenderer_tpu_torch.ops import vertex_graph
    from dtrenderer_tpu_torch.ops.pipeline import DrawSpec, draw_meshes

    dev = torch.device(DEVICE)
    api_submission = api_submission_fn(dev)
    scenes = [(s.name, s.width, s.height, s.submission) for s in (
        bench_scenes.fill_scene(device=dev), cfg4,
        bench_scenes.soup_scene(device=dev), cfg5, sphere)]
    scenes.append(("api_frame_render_meshes", 1920, 1080, api_submission))
    eager_pack = vertex_batch.pack  # the pass, eager and uncached

    def pack(fn, sub, w, h):
        return fn(sub.draws, sub.view_proj, sub.light, sub.sampling_mode, w,
                  h, near_clip=sub.near_clip)

    def counts():
        return (vertex_graph.EAGER, vertex_graph.CAPTURES,
                vertex_graph.REPLAYS)

    reps = 20
    for name, w, h, submission in scenes:
        vertex_graph.reset()
        for i, t in enumerate((0.5, 0.5, 0.5, 0.3, 0.7)):
            sub = submission(t)
            got = [x.clone() for x in pack(pipeline.pack_draws, sub, w, h)]
            same_batch(f"{name} sighting {i + 1}, t = {t}", got,
                       pack(eager_pack, sub, w, h))
        if counts() != (1, 1, 4):
            raise AssertionError(f"{name}: (eager, captures, replays) "
                                 f"{counts()}, want (1, 1, 4)")
        sub = submission(0.5)
        n_ops = {way: host_ops(lambda: pack(fn, sub, w, h)) for way, fn in (
            ("eager", eager_pack), ("replay", pipeline.pack_draws))}
        host = {"eager": [], "replay": []}
        for way in ("eager", "replay", "replay", "eager"):
            fn = eager_pack if way == "eager" else pipeline.pack_draws
            host[way] += [timed(lambda: pack(fn, sub, w, h))[1]
                          for _ in range(reps // 2)]
        ev_eager = cuda_ms(lambda: pack(eager_pack, sub, w, h), reps)
        ev_replay = cuda_ms(lambda: pack(pipeline.pack_draws, sub, w, h),
                            reps)
        want = (1, 1, 4 + 1 + reps + reps + 1)
        if counts() != want:
            raise AssertionError(f"{name}: timed stages were not all "
                                 f"replays: {counts()}, want {want}")
        (stat,) = vertex_graph.stats()
        print(f"vertex stage graph {name} {w}x{h}: {len(sub.draws)} draws, "
              f"{stat['rows']} setup rows; replay bit-equal to the eager "
              f"pass at t = 0.5, 0.3, 0.7; (eager, captures, replays) "
              f"{counts()}, graph pool "
              f"{stat['pool_mib']:.1f} MiB; host ops a call: eager "
              f"{n_ops['eager']}, replay {n_ops['replay']}; stage ms, host "
              f"clock to a synchronise (median of {reps}): eager "
              f"{np.median(host['eager']):.4f}, replay "
              f"{np.median(host['replay']):.4f}; CUDA events over {reps} "
              f"back-to-back calls: eager {ev_eager:.4f}, replay "
              f"{ev_replay:.4f} ms a call [{card}]")

    # a mesh and a texture changed in place: the next replay reads them
    vertex_graph.reset()
    sub = cfg4.submission(0.5)
    head = sub.draws[0]
    for _ in range(3):
        before = [x.clone() for x in pack(pipeline.pack_draws, sub, cfg4.width,
                                          cfg4.height)]
    verts, texels = head.mesh.verts.clone(), head.texture.clone()
    head.mesh.verts.mul_(1.25)
    head.texture.mul_(0.5)
    got = [x.clone() for x in pack(pipeline.pack_draws, sub, cfg4.width,
                                   cfg4.height)]
    want = pack(eager_pack, sub, cfg4.width, cfg4.height)
    head.mesh.verts.copy_(verts)
    head.texture.copy_(texels)
    same_batch("config 4, head mesh and texture changed in place", got, want)
    if torch.equal(got[0], before[0]) or torch.equal(got[4], before[4]):
        raise AssertionError("config 4: the replay did not see the change")
    if counts() != (1, 1, 3):
        raise AssertionError(f"in-place change: {counts()}, want (1, 1, 3)")
    print(f"vertex stage graph: config 4's head mesh and texture changed in "
          f"place are read by the next replay, bit-equal to the eager pass "
          f"[{card}]")

    # two identical opaque runs around a translucent draw, one draw_meshes
    vertex_graph.reset()
    head, box, ball4, _ = sub.draws
    trans = DrawSpec(ball4.mesh, ball4.model, color=(0.8, 0.5, 0.9, 0.6),
                     shading="phong")
    seq = [head, box, trans, head, box]
    fb4 = fblib.create(cfg4.height, cfg4.width, dev)

    def frame4():
        out = draw_meshes(fb4, sub.view_proj, seq, light=sub.light,
                          sampling_mode=sub.sampling_mode)
        return [t.clone() for t in out]

    graphed = [frame4() for _ in range(3)]
    with mock.patch.object(vertex_graph, "pack", eager_pack):
        eager_frame = frame4()
    for i, fr in enumerate(graphed):
        bits_equal(f"two opaque runs around a translucent draw, frame {i}",
                   fblib.Framebuffer(*fr), fblib.Framebuffer(*eager_frame))
    print(f"vertex stage graph: config 4 [head, cube, translucent sphere, "
          f"head, cube] in one draw_meshes, 3 frames bit-equal to the eager "
          f"frame; (eager, captures, replays) {counts()} [{card}]")

    vertex_graph.reset()


def band_graph_check(card, cfg5):
    """Config 5 on a 1 x 8 x 1 mesh (cuda:0 on one card; every card cycled
    on more, each staging its own copy of the scene), per band and shared,
    bit-equal to the eager pass's single launch at four times; prints each
    card's keys seen once and captured (do the per-call copies of the scene
    reach replays?)."""
    from unittest import mock

    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline, vertex_batch
    from dtrenderer_tpu_torch.ops import vertex_graph
    from dtrenderer_tpu_torch.parallel import shard

    dev = torch.device(DEVICE)
    eager_pack = vertex_batch.pack

    def counts():
        return (vertex_graph.EAGER, vertex_graph.CAPTURES,
                vertex_graph.REPLAYS)

    vertex_graph.reset()
    mesh8 = shard.make_mesh(frames=1, rows=8)
    fb5 = fblib.create(cfg5.height, cfg5.width, dev)
    cut5 = shard.shard_fb(fb5, mesh8)
    for t in (0.5, 0.3, 0.7, 0.5):
        sub5 = cfg5.submission(t)
        d = sub5.draws[0]
        kw = dict(texture=d.texture, light=sub5.light, color=d.color,
                  shading=d.shading, sampling_mode=sub5.sampling_mode,
                  near_clip=sub5.near_clip, backend="fused")
        with mock.patch.object(vertex_graph, "pack", eager_pack):
            single = pipeline.draw_mesh(fb5, d.mesh, d.model,
                                        sub5.view_proj, **kw)
        for way, opts in (("per band", None),
                          ("shared", dict(row_bands=8))):
            got = shard.gather_fb(shard.draw_mesh_sharded(
                cut5, d.mesh, d.model, sub5.view_proj, mesh8,
                raster_opts=opts, **kw), dev)
            bits_equal(f"config 5, 8 bands {way}, t = {t}", got, single)
    devices = [str(d) for d in mesh8.distinct()]
    print(f"vertex stage graph: config 5 on a 1x8x1 mesh of "
          f"{', '.join(devices)}, per band and shared, bit-equal to the "
          f"eager pass's single launch at t = 0.5, 0.3, 0.7, 0.5; (eager, "
          f"captures, replays) {counts()} [{card}]")
    for d in devices:  # does each card's copy of the scene reach replays?
        keys = vertex_graph.device_keys(d)
        print(f"vertex stage graph: config 5 on 8 bands, {d}: "
              f"{len(keys.first)} key(s) seen once, captured keys "
              f"{[(s['period'], s['replays']) for s in vertex_graph.stats() if s['device'] == d]}"
              f" as (period, replays), over {keys.clock} calls")
    vertex_graph.reset()


def per_draw_pack(draws, view_proj, light, sampling_mode, frame_w, frame_h,
                  cull_backfaces=True, near_clip=True, mvps=None):
    """pipeline.pack_draws as it was before its batched pass: prepare_draw
    and pack_payload per draw, then torch.cat (the baseline of
    many_keys_frame)."""
    import torch

    from dtrenderer_tpu_torch.models.primitives import white_texture
    from dtrenderer_tpu_torch.ops import pipeline
    from dtrenderer_tpu_torch.ops.render_fused import (
        make_texture_lut, pack_flags, pack_payload,
    )
    from dtrenderer_tpu_torch.utils.math3d import mat4mul

    white = white_texture(device=light.direction.device)
    lut, meta = make_texture_lut(
        [d.texture if d.texture is not None else white for d in draws])
    parts = []
    for i, (d, m) in enumerate(zip(draws, meta)):
        mvp = mvps[i] if mvps is not None else mat4mul(view_proj, d.model)
        setup, attrs10 = pipeline.prepare_draw(
            d.mesh, d.model, view_proj, mvp,
            d.normal_mat if d.normal_mat is not None else d.model, light,
            d.color, d.shading, frame_w, frame_h, cull_backfaces, near_clip)
        flags = pack_flags(d.shading == "phong",
                           (d.sampling or sampling_mode) == "bilinear")
        parts.append((setup.coef, setup.bbox, setup.valid,
                      pack_payload(attrs10, m, flags)))
    return pipeline.DrawBatch(*(torch.cat(x) for x in zip(*parts)), lut)


def many_keys_frame(card, n_keys: int = 16, reps: int = 10):
    """A frame of n_keys separate draw_mesh calls (distinct meshes, so
    n_keys submission keys a frame), and the same frame with every mesh
    copied anew for each call's frame and stage (no key ever recurs: every
    call runs eager). Each against
    the per-draw stage that the batched pass replaced (per_draw_pack),
    interleaved per-draw, graph, graph, per-draw: frames bit-equal, host ms
    per frame to a synchronise (median of reps), and the vertex stage
    alone (pack_draws of the frame's draws)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from dtrenderer_tpu_torch.models import primitives
    from dtrenderer_tpu_torch.models.mesh import Mesh
    from dtrenderer_tpu_torch.ops import fb as fblib, pipeline, vertex_graph
    from dtrenderer_tpu_torch.ops.shading import make_light
    from dtrenderer_tpu_torch.utils import math3d

    dev = torch.device(DEVICE)
    w, h = 1920, 1080
    tex = primitives.checkerboard(64, 8, device=dev)
    proj = math3d.perspective(np.pi / 3, w / h, 0.1, 100.0, device=dev)
    light = make_light((0.3, 0.7, 1.0), 0.15, device=dev)
    meshes = [primitives.uv_sphere(12 + i % 4, 16 + 2 * (i % 3), device=dev)
              for i in range(n_keys)]
    fb0 = fblib.create(h, w, dev)

    def model(i, t):
        x, y = (i % 8) - 3.5, 1.2 * (i // 8) - 0.6
        return math3d.model_matrix((x, y, -9.0),
                                   math3d.rotate_y(t + 0.3 * i, device=dev),
                                   0.5, device=dev)

    def draws(frame_meshes, t):
        return [pipeline.DrawSpec(m, model(i, t), texture=tex,
                                  shading="phong" if i % 2 else "gouraud")
                for i, m in enumerate(frame_meshes)]

    def frame(specs):
        out = fb0
        for d in specs:
            out = pipeline.draw_mesh(out, d.mesh, d.model, proj,
                                     texture=d.texture, light=light,
                                     shading=d.shading,
                                     sampling_mode="bilinear",
                                     backend="fused")
        return out

    def stage(specs):
        return [pipeline.pack_draws([d], proj, light, "bilinear", w, h)
                for d in specs]

    def fresh():  # this frame's copies of the meshes, at new addresses
        return [Mesh(*(t.clone() for t in m)) for m in meshes]

    for name, make in (("recurring", lambda: meshes), ("fresh", fresh)):
        vertex_graph.reset()
        kept = []  # fresh copies stay alive, so no address comes back
        specs = draws(meshes, 0.5)
        want = None
        with mock.patch.object(pipeline, "pack_draws", per_draw_pack):
            want = frame(specs)
        for _ in range(3):
            kept.append(make())
            got = frame(draws(kept[-1], 0.5))
        bits_equal(f"{n_keys} keys a frame, {name} meshes", got, want)
        ms, stage_ms = [], []  # per batch: (way, [ms])
        before = (vertex_graph.EAGER, vertex_graph.CAPTURES,
                  vertex_graph.REPLAYS)
        for way in ("per-draw", "graph", "graph", "per-draw"):
            with (mock.patch.object(pipeline, "pack_draws", per_draw_pack)
                  if way == "per-draw" else contextlib.nullcontext()):
                ms.append((way, []))
                stage_ms.append((way, []))
                for _ in range(reps):
                    kept += [make(), make()]
                    specs, specs_s = draws(kept[-2], 0.5), draws(kept[-1],
                                                                  0.5)
                    ms[-1][1].append(timed(lambda: frame(specs))[1])
                    stage_ms[-1][1].append(timed(lambda: stage(specs_s))[1])
        after = (vertex_graph.EAGER, vertex_graph.CAPTURES,
                 vertex_graph.REPLAYS)
        delta = tuple(a - b for a, b in zip(after, before))
        calls = 2 * 2 * reps * n_keys  # frames and stages, two batches
        want_delta = (0, 0, calls) if name == "recurring" else (calls, 0, 0)
        if delta != want_delta:
            raise AssertionError(f"{n_keys} keys a frame, {name}: (eager, "
                                 f"captures, replays) {delta}, want "
                                 f"{want_delta}")
        def medians(batches):
            both = {w: np.median([t for w2, ts in batches if w2 == w
                                  for t in ts]) for w in ("per-draw", "graph")}
            return (f"per-draw {both['per-draw']:.4f}, graph "
                    f"{both['graph']:.4f} (batches "
                    f"{', '.join(f'{np.median(ts):.4f}' for _, ts in batches)})")

        print(f"many keys: {n_keys} draw_mesh calls a frame, {name} meshes "
              f"({sum(m.faces.shape[0] for m in meshes)} triangles), "
              f"frames bit-equal to the per-draw stage's; (eager, captures, "
              f"replays) in the timed frames {delta}; captured keys "
              f"{len(vertex_graph.stats())}; host ms a frame, median of "
              f"{2 * reps} (per-draw, graph, graph, per-draw batches of "
              f"{reps}): {medians(ms)}; the stage alone: "
              f"{medians(stage_ms)} [{card}]")
    vertex_graph.reset()


def steady_device_frames(card):
    """Each bench cell (bench_torch/cells.py) through the bench's own traced
    window (bench_torch/run.py trace_cell: the cell built anew, the bench's
    warm-up frames, then its traced frames, which must make no eager pass
    and no capture and replay a vertex graph at least once a frame where
    the cell's route does): the device's busy ms a frame of steady
    frames."""
    import torch

    from bench_torch import cells as bench_cells, run as bench_run
    from dtrenderer_tpu_torch.ops import vertex_graph

    dev = torch.device(DEVICE)
    counts = bench_run.CARD_COUNTS
    for cell in bench_cells.CELLS:
        vertex_graph.reset()
        extra = {}
        bench_run.trace_cell(cell, dev, counts, os.path.join(
            REPO, "bench_torch", "traces", "steady"), extra)
        if extra["device_ms_per_frame"] is None:
            raise AssertionError(f"{cell.name}: the profiler saw no device "
                                 f"operation")
        print(f"steady device time {cell.name}: {counts.trace} traced frames "
              f"after {counts.warmup} warm-up frames, device_ms_per_frame "
              f"{extra['device_ms_per_frame']:.4f}, busy share "
              f"{extra['device_busy_share']:.4f}, window "
              f"{extra['window_ms']:.3f} ms, vertex graph a frame "
              f"{extra['vertex_graph_per_frame']}, launches a frame "
              f"{extra['launches_per_frame']} [{card}]")
        torch.cuda.empty_cache()
    vertex_graph.reset()


# --------------------------------------------------------- reference check


def reference_check():
    """Small frames on the card vs the same frames on the CPU."""
    import torch

    from dtrenderer_tpu_torch.models import scenes
    from dtrenderer_tpu_torch.ops import fb as fblib

    cases = [(f"config{n} {b}", scenes.ALL_CONFIGS[n],
              dict(width=160, height=120, backend=b))
             for n in (1, 2, 3) for b in ("ref", "pallas", "fused")]
    cases += [("config4 fused", scenes.make_config4,
               dict(width=160, height=120)),
              ("config5 fused", scenes.make_config5,
               dict(width=256, height=128, n_tris=2000))]
    cases += [(f"translucent sphere {e}", translucent_sphere,
               dict(width=160, height=120, n_lat=16, n_lon=24, engine=e))
              for e in ("tile", "scan")]
    for tag, make, kw in cases:
        out = []
        for dev in (torch.device(DEVICE), torch.device("cpu")):
            spec = make(**kw, device=dev)
            fb0 = fblib.create(spec.height, spec.width, dev)
            out.append(spec.frame(fb0.color, fb0.depth, 0.6))
        compare(f"{tag} {spec.width}x{spec.height}, card vs CPU",
                out[0][1], out[0][0], out[1][1], out[1][0])


def compare_nan(tag, z_a, c_a, z_b, c_b):
    """compare() for planes that may hold NaN: z bit-equal, colour NaN at the
    same channels, elsewhere max |diff| <= SRC_TOL and packed u8 within +-1
    with zero outliers. Returns (max |diff|, covered px, NaN px)."""
    import torch

    from dtrenderer_tpu_torch.utils.color import pack_srgb_u8

    z_a, z_b, c_a, c_b = z_a.cpu(), z_b.cpu(), c_a.cpu(), c_b.cpu()
    if not torch.equal(z_a.view(torch.int32), z_b.view(torch.int32)):
        n = int((z_a.view(torch.int32) != z_b.view(torch.int32)).sum())
        raise AssertionError(f"{tag}: z differs at {n} pixels")
    nan = torch.isnan(c_b)
    if not torch.equal(torch.isnan(c_a), nan):
        raise AssertionError(f"{tag}: NaN at different colour channels")
    err = float(torch.where(nan, 0.0, c_a - c_b).abs().max())
    if not err <= SRC_TOL:
        raise AssertionError(f"{tag}: colour max |diff| {err} > {SRC_TOL}")
    ok = ~nan.any(-1)
    du8 = pack_srgb_u8(c_a).int() - pack_srgb_u8(c_b).int()
    n_out = int((du8[ok].abs() > 1).sum())
    if n_out:
        raise AssertionError(f"{tag}: {n_out} packed u8 channels differ by >1")
    return err, int(torch.isfinite(z_a).sum()), int((~ok).sum())


def edge_cases_check() -> dict:
    """The degenerate and non-finite cases of models/edge_cases.py (32x128,
    the camera in a box 64x128) drawn on the card and on the CPU through
    draw_meshes on "fused" (K1), draw_mesh on "pallas" (K2) and "ref", and
    draw_mesh_ordered on "tile" (K3): depth bit-equal, colour NaN at the
    same channels and within SRC_TOL elsewhere, packed u8 within +-1 with
    zero outliers. Then, on the card, each kernel against its plain twin
    for the case's packed draws (a texture at LUT base > 0 included) and
    K2's ids against the CPU's; and math3d.to_i32 on the card against the
    CPU and against torch's own CUDA cast. Returns the launch counts of the
    routes' draws on the card."""
    import torch

    from dtrenderer_tpu_torch.models import edge_cases as ec
    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.ops import raster_ordered as ro
    from dtrenderer_tpu_torch.ops import raster_pallas as rp
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.utils.math3d import to_i32

    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    t0 = time.perf_counter()
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 2.0**31,
                      -2.0**31, 2147483520.0, 1e12, -1e12, -0.0, 0.5, -0.5,
                      1.5, -1.5, 3e9, -3e9])
    on_card = to_i32(x.to(dev))
    if not (torch.equal(on_card.cpu(), to_i32(x))
            and torch.equal(on_card, x.to(dev).to(torch.int32))):
        raise AssertionError(f"to_i32: card {on_card.tolist()}, CPU "
                             f"{to_i32(x).tolist()}, CUDA cast "
                             f"{x.to(dev).to(torch.int32).tolist()}")
    routes = ("fused", "pallas", "ref", "tile")
    cases = [make() for make in ec.CASES.values()]
    reset_counts()
    card = {(c.name, r): ec.render(c, r, dev) for c in cases for r in routes}
    torch.cuda.synchronize()
    got = read_counts()
    n_draws = sum(len(c.draws) for c in cases)
    want = {"K1": len(cases), "K2": n_draws, "K3": n_draws,
            "VP": len(cases) + 3 * n_draws, "BN": len(cases) + 2 * n_draws,
            "DS": 2 * n_draws}
    if not launches_ok(got, want):
        raise AssertionError(f"edge cases: kernel launches {got}, want {want}")
    for case in cases:
        h, w = case.height, case.width
        where = f"edge case {case.name!r} {w}x{h}"
        for r in routes:
            fb = ec.render(case, r, cpu)
            _, covered, nan_px = compare_nan(
                f"{where} on {r}, card vs CPU", card[case.name, r].depth,
                card[case.name, r].color, fb.depth, fb.color)
        batch, bins, light = ec.pack(case, dev)
        args = (batch.coef, batch.payload, bins, batch.tex_lut, light, h, w)
        z1, s1, _ = rf.render_fused(*args)
        z1p, s1p, _ = rf.render_fused_plain(*args)
        compare_nan(f"{where}: K1 vs plain", z1, s1, z1p, s1p)
        z2, t2 = rp.rasterize_bins(batch.coef, bins, h, w)
        z2p, t2p = rp.rasterize_pallas_plain(batch.coef, bins, h, w)
        batch_c, bins_c, _ = ec.pack(case, cpu)
        z2c, t2c = rp.rasterize_bins(batch_c.coef, bins_c, h, w)
        for name, a, b in (("z", z2, z2p), ("z on the CPU", z2, z2c),
                           ("ids", t2, t2p), ("ids on the CPU", t2, t2c)):
            if not torch.equal(a.cpu().view(torch.int32),
                               b.cpu().view(torch.int32)):
                raise AssertionError(f"{where}: K2 {name} differs")
        fb0 = fblib.clear(fblib.create(h, w, dev), ec.CLEAR)
        planes = (fb0.color, fb0.depth, h, w)
        c3, d3 = ro.render_ordered_bins(*args[:5], *planes)
        c3p, d3p = ro.render_ordered_plain(*args[:5], *planes)
        compare_nan(f"{where}: K3 vs plain", d3, c3, d3p, c3p)
        torch.cuda.synchronize()
        print(f"{where}: card = CPU on {', '.join(routes)} (depth "
              f"bit-equal, covered px {covered}, NaN px {nan_px}); K1, K2, "
              f"K3 = plain twins on the card, K2 ids = CPU ("
              f"{int(bins.tri_ids.shape[0])} pairs)")
    print(f"edge cases: {len(cases)} cases x {len(routes)} routes, "
          f"{time.perf_counter() - t0:.1f} s, kernel launches {got}; "
          f"to_i32 card = CPU = CUDA cast on {x.numel()} values")
    return got


def draw2d_text_check():
    """Every 2D verb, both text functions with both fonts, a textured
    render_triangle with per-corner q and the HUD, 160x120, on the card
    against the CPU after each verb: depth bit-equal, colour max |diff| <=
    1e-6, packed u8 within +-1 with zero outliers; a 2D verb leaves the
    depth it was given bit for bit."""
    import torch

    from dtrenderer_tpu_torch import api
    from dtrenderer_tpu_torch.assets.font import bake_builtin_font, encode_text
    from dtrenderer_tpu_torch.debug import DebugHud, FrameCounters
    from dtrenderer_tpu_torch.models import primitives
    from dtrenderer_tpu_torch.ops import text as textlib
    from dtrenderer_tpu_torch.utils.color import rgba

    w, h = 160, 120
    codes = encode_text("Card vs CPU: iiii WWWW {~}")

    def steps(dev):
        """[(name, touches depth, state)] after each verb."""
        tex = primitives.checkerboard(16, 4, (1, 0.5, 0.1, 0.9),
                                      (0.1, 0.3, 1.0, 0.9), device=dev)
        mono = bake_builtin_font(14, device=dev)
        sans = bake_builtin_font(14, "sans", device=dev)
        t2d = lambda **kw: api.transform2d(device=dev, **kw)
        st = api.clear(api.new_state(w, h, device=dev),
                       rgba(0.06, 0.07, 0.12, 1.0))
        out = []

        def add(name, st, depth=False):
            out.append((name, depth, st))
            return st

        st = add("render_triangle textured, per-corner q", api.render_triangle(
            st, (20, 10, 0.3, 1.0), (150, 30, 0.3, 0.5), (40, 110, 0.3, 0.25),
            color=rgba(1, 1, 1, 0.9), uv0=(0, 1), uv1=(1, 1), uv2=(0, 0),
            texture=tex, sampling_mode="bilinear"), True)
        st = add("rect plain", api.render_rectangle(
            st, (10.3, 7.7), (60.2, 41.9), rgba(0.9, 0.2, 0.2, 0.6)))
        st = add("rect rotated", api.render_rectangle(
            st, (70, 20), (140, 60), rgba(0.2, 0.6, 0.9, 0.5),
            t2d(rotation=0.48, scale=(1.2, 0.8), anchor=(0.25, 0.75))))
        st = add("line x-major", api.render_line(
            st, (5, 100), (150, 31), rgba(1, 1, 0.3, 1)))
        st = add("line y-major", api.render_line(
            st, (120.6, 4.2), (101.3, 117.9), rgba(0.3, 1, 1, 0.7)))
        st = add("circle filled", api.render_circle(
            st, (60.2, 70.7), 28.3, rgba(0.3, 0.9, 0.4, 0.8)))
        st = add("circle outline", api.render_circle(
            st, (100, 60), 40.5, rgba(1, 1, 1, 0.9), filled=False))
        st = add("blit nearest, rotated scaled", api.render_bitmap(
            st, tex, (50, 40), t2d(rotation=-0.6, scale=1.7)))
        st = add("blit bilinear, rotated scaled", api.render_bitmap(
            st, tex, (110, 80), t2d(rotation=0.9, scale=3.0),
            sampling_mode="bilinear", tint=(0.9, 0.8, 0.7, 0.8)))
        for fname, font in (("mono", mono), ("sans", sans)):
            st = add(f"draw_text {fname}", st._replace(fb=textlib.draw_text(
                st.fb, font, codes, (-6, 12), (1, 1, 1, 0.9), 1)))
            st = add(f"draw_text_proportional {fname}", st._replace(
                fb=textlib.draw_text_proportional(
                    st.fb, font, codes, (3, -4), (1, 0.95, 0.7, 1), 2)))
        hud = DebugHud(device=dev)
        hud.frame_ms = 16.67
        hud.push_text("pushed line")
        counters = FrameCounters(*[
            torch.tensor(v, dtype=torch.int32, device=dev)
            for v in (2992, 518, 5264, 7)])
        add("HUD with counters", st._replace(fb=hud.render(st.fb, counters)))
        return out

    card, cpu = steps(torch.device(DEVICE)), steps(torch.device("cpu"))
    depth_before = card[0][2].fb.depth
    for (name, touches_depth, a), (_, _, b) in zip(card, cpu):
        compare(f"2D/text {name} {w}x{h}, card vs CPU", a.fb.depth,
                a.fb.color, b.fb.depth, b.fb.color)
        if touches_depth:
            depth_before = a.fb.depth
        elif not torch.equal(a.fb.depth.view(torch.int32),
                             depth_before.view(torch.int32)):
            raise AssertionError(f"2D/text {name}: the verb changed depth")


# -------------------------------------------------------------------- main


def build_all():
    """One nvcc per kernel source, all started together."""
    from dtrenderer_tpu_torch.kernels import binning, draw2d
    from dtrenderer_tpu_torch.kernels import raster_visibility, render_fused
    from dtrenderer_tpu_torch.kernels import render_ordered, shade_deferred
    from dtrenderer_tpu_torch.kernels import vertex_pass

    mods = (render_fused, raster_visibility, render_ordered, vertex_pass,
            binning, shade_deferred, draw2d)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
        infos = list(ex.map(lambda m: m.library()[1], mods))
    print(f"build of {len(mods)} kernels: {time.perf_counter() - t0:.1f} s")
    for m, info in zip(mods, infos):
        print(f"  {m.SOURCE}: {info.seconds:.1f} s (cached={info.cached})")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    return mods


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not (argv in ([], ["--bands"])
            or (len(argv) == 2 and argv[0] in (
                "--bin-against", "--verbs-against", "--verb-times"))):
        raise SystemExit("usage: python3 chip_smoke.py [--bands | "
                         "--bin-against DIR | --verbs-against DIR]")
    if not os.path.isdir(os.path.join(REPO, "dtrenderer_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (dtrenderer_tpu_torch/ is missing)")
    if argv[:1] == ["--verb-times"]:
        return verb_times_of(argv[1])
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dtrenderer_tpu_torch.models import scenes
    from dtrenderer_tpu_torch.ops import render_fused as rf
    from dtrenderer_tpu_torch.ops import vertex_batch

    *raster, vp, _, _, _ = build_all()
    for m in raster:
        if m.tile_shape() != (rf.TILE_H, rf.TILE_W):
            raise AssertionError(f"{m.SOURCE} tile {m.tile_shape()} != "
                                 f"{(rf.TILE_H, rf.TILE_W)}")
    if vp.table_cols() != vertex_batch.TABLE_COLS:
        raise AssertionError(f"{vp.SOURCE} table of {vp.table_cols()} "
                             f"columns != {vertex_batch.TABLE_COLS}")

    if argv[:1] == ["--verbs-against"]:
        verbs_against(card, argv[1])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    cfg4 = scenes.make_config4(device=dev)
    cfg5 = scenes.make_config5(device=dev)
    cfg4p = scenes.make_config4(backend="pallas", device=dev)
    cfg5p = scenes.make_config5(backend="pallas", device=dev)
    sphere = translucent_sphere(1920, 1080, dev)
    mixed = mixed_config4(cfg4)
    print(f"scene set-up {time.perf_counter() - t0:.1f} s: config 4 "
          f"{cfg4.n_tris} tris, config 5 {cfg5.n_tris} tris, translucent "
          f"sphere {sphere.n_tris} tris")
    if argv:  # the band split alone over every card, or another binning
        if argv[0] == "--bands":
            band_paths(card, cfg4, cfg5, sphere)
            band_graph_check(card, cfg5)
        else:
            binning_against_parent(card, argv[1], cfg4, cfg5, sphere)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    k1_4 = k1_vs_plain(cfg4, card)
    k1_5 = k1_vs_plain(cfg5, card)
    k2_5 = k2_vs_plain(cfg5p, card)
    k2_4 = k2_vs_plain(cfg4p, card)
    k3 = k3_vs_plain(sphere, card)
    ds_5 = ds_vs_plain(cfg5p, card)
    ds_4 = ds_vs_plain(cfg4p, card)
    k1m_5 = k1_merge_vs_plain(cfg5, card)
    k1m_4 = k1_merge_vs_plain(cfg4, card)
    k1m_8 = k1_merge_vs_plain(cfg5, card, rows=8)
    stress_vs_plain()
    d2 = draw2d_kernel_vs_plain(card)

    launches = {"K1": 0, "K2": 0, "K3": 0, "VP": 0, "BN": 0, "DS": 0,
                "D2": 0}
    paths = [
        ("K1 path", [(cfg4, 3), (cfg5, 2)],
         {"K1": 5, "K2": 0, "K3": 0, "VP": 5, "BN": 5, "DS": 0}),
        ("K2 path config 5", [(cfg5p, 2)],
         {"K1": 0, "K2": 2, "K3": 0, "VP": 2, "BN": 2, "DS": 2}),
        ("K2 path config 4", [(cfg4p, 2)],
         {"K1": 0, "K2": 8, "K3": 0, "VP": 8, "BN": 8, "DS": 8}),
        ("K3 path", [(sphere, 3)],
         {"K1": 0, "K2": 0, "K3": 3, "VP": 3, "BN": 3, "DS": 0}),
        ("mixed path", [(mixed, 2)],
         {"K1": 4, "K2": 0, "K3": 2, "VP": 6, "BN": 6, "DS": 0}),
    ]
    for tag, runs, want in paths:
        for k, n in main_path(tag, runs, want, card).items():
            launches[k] += n
    for k, n in api_frame_path(card).items():
        launches[k] += n
    for k, n in band_paths(card, cfg4, cfg5, sphere).items():
        launches[k] += n
    vp = vertex_kernel_vs_plain(card, cfg4, cfg5, sphere)
    vertex_stage_graph(card, cfg4, cfg5, sphere)
    band_graph_check(card, cfg5)
    many_keys_frame(card)
    steady_device_frames(card)
    bn = binning_kernel_vs_plain(card, cfg4, cfg5, sphere)

    stages_fused(cfg4, card)
    stages_fused(cfg5, card)
    merge_ops = merge_device_ops(cfg5, card)
    stages_pallas(cfg4p, card)
    stages_pallas(cfg5p, card)
    staging_vs_prepare_draw(card, cfg4p, cfg5p)
    stages_ordered(sphere, card)
    reference_check()
    draw2d_text_check()
    for k, n in edge_cases_check().items():
        launches[k] += n

    def entry(name, source, replaces, key, res, **extra):
        err, ms, plain_ms, (bound_ms, bound_by) = res[:4]
        return {"name": name, "route": "cuda",
                "source": f"dtrenderer_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "launch_loop_ms": list(res[-1]), **extra}

    report = {"kernels": [
        # the draw call's path: the merging entry (config 5); without the
        # merge ("no_merge") as the bench's stages and the band phase run it
        entry("render_fused", "render_fused.cu",
              "dtrenderer_tpu/ops/render_fused.py:269", "K1",
              (max(k1_4[0], k1_5[0], k1m_4[0], k1m_5[0], k1m_8),
               *k1m_5[1:4], k1m_5[7]),
              ms_config4_1080p=k1m_4[1], plain_ms_config4_1080p=k1m_4[2],
              bound_ms_config4_1080p=k1m_4[3][0],
              launch_loop_ms_config4_1080p=list(k1m_4[7]),
              winners=k1m_5[4], winners_config4_1080p=k1m_4[4],
              torch_merge_ms=k1m_5[5], torch_merge_ms_config4_1080p=k1m_4[5],
              ms_no_merge=k1_5[1], plain_ms_no_merge=k1_5[2],
              bound_ms_no_merge=k1_5[3][0],
              launch_loop_ms_no_merge=list(k1m_5[6]),
              ms_no_merge_config4_1080p=k1_4[1],
              plain_ms_no_merge_config4_1080p=k1_4[2],
              bound_ms_no_merge_config4_1080p=k1_4[3][0],
              launch_loop_ms_no_merge_config4_1080p=list(k1m_4[6]),
              device_ops_frame=merge_ops["after"][0],
              device_us_frame=merge_ops["after"][1],
              device_ops_frame_torch_merge=merge_ops["before"][0],
              device_us_frame_torch_merge=merge_ops["before"][1],
              surviving_bits=k1_5[4], surviving_bits_config4_1080p=k1_4[4]),
        entry("raster_visibility", "raster_visibility.cu",
              "dtrenderer_tpu/ops/raster_pallas.py:36", "K2",
              (max(k2_4[0], k2_5[0]), *k2_5[1:]),
              ms_config4_1080p=k2_4[1], plain_ms_config4_1080p=k2_4[2],
              bound_ms_config4_1080p=k2_4[3][0],
              launch_loop_ms_config4_1080p=list(k2_4[5]),
              surviving_bits=k2_5[4], surviving_bits_config4_1080p=k2_4[4]),
        entry("render_ordered", "render_ordered.cu",
              "dtrenderer_tpu/ops/raster_ordered.py:51", "K3", k3),
        entry("vertex_pass", "vertex_pass.cu",
              "dtrenderer_tpu/ops/pipeline.py:134 prepare_draw (the "
              "XLA-fused vertex stage: no pl.pallas_call)", "VP",
              vp["config5_4k_1m"], **{
                  f"{k}_{name}": v for name, res in vp.items()
                  if name != "config5_4k_1m"
                  for k, v in (("ms", res[1]), ("plain_ms", res[2]),
                               ("bound_ms", res[3][0]),
                               ("launch_loop_ms", list(res[-1])))}),
        entry("binning", "binning.cu",
              "dtrenderer_tpu/ops/binning.py:859 bin_triangles (XLA ops: no "
              "pl.pallas_call)", "BN", bn["config5_4k_1m"],
              host_syncs=bn["config5_4k_1m"][4],
              plain_host_syncs=bn["config5_4k_1m"][5],
              pairs=bn["config5_4k_1m"][6],
              device_ops=bn["config5_4k_1m"][7],
              graph_ms=list(bn["config5_4k_1m"][8]), **{
                  f"{k}_{name}": v for name, res in bn.items()
                  if name != "config5_4k_1m"
                  for k, v in (("ms", res[1]), ("plain_ms", res[2]),
                               ("bound_ms", res[3][0]), ("pairs", res[6]),
                               ("device_ops", res[7]),
                               ("graph_ms", list(res[8])),
                               ("launch_loop_ms", list(res[-1])))}),
        entry("shade_deferred", "shade_deferred.cu",
              "dtrenderer_tpu/ops/pipeline.py:164 shade_deferred (XLA ops: "
              "no pl.pallas_call)", "DS", (max(ds_4[0], ds_5[0]), *ds_5[1:]),
              ms_config4_1080p=ds_4[1], plain_ms_config4_1080p=ds_4[2],
              bound_ms_config4_1080p=ds_4[3][0],
              launch_loop_ms_config4_1080p=list(ds_4[4])),
        # the API frame's ten launches a frame, summed (per verb beside)
        entry("draw2d", "draw2d.cu",
              "dtrenderer_tpu/ops/draw2d.py, text.py and api.py "
              "render_triangle (XLA ops: no pl.pallas_call)", "D2",
              (d2["max_abs_err"], d2["total"]["loop_ms"],
               d2["total"]["plain_ms"], (d2["total"]["bound_ms"], "bytes"),
               (d2["total"]["loop_ms"],)),
              elements_differing=d2["n_diff"],
              wrapper_ms=d2["total"]["wrapper_ms"], **{
                  f"{k}_{name.replace(' ', '_')}": v
                  for name, r in d2["rows"].items()
                  for k, v in zip(("ms", "wrapper_ms", "plain_ms",
                                   "bound_ms"), r)
                  if v is not None}),
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
