#!/usr/bin/env python3
"""Hardware smoke gate of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

  1. device: require CUDA, print the card's name and power limit;
  2. build: compile csrc/render_fused.cu with nvcc (timed);
  3. kernel vs plain twin at the main path's shapes: config 4 at 1920x1080
     and config 5 at 3840x2160 with 1,000,000 triangles (t = 0.5): z equal
     bit for bit, src max |diff| <= 1e-6, packed sRGB u8 within +-1 with
     zero outliers; both timed with CUDA events;
  4. main path: make_config4().frame for 3 frames and make_config5().frame
     for 2 frames through the public draw_meshes/draw_mesh, with the kernel
     launch count reset just before and read just after (one launch per
     frame); ms/frame, shaded Mpix/s and Mtris/s;
  5. stage breakdown of one frame per scene (vertex stage + packing,
     binning, kernel, merge), after the counted main-path window;
  6. reference check: small config 4 (160x120) and config 5 (256x128, 2,000
     triangles) frames rendered on the card against the same frames rendered
     on the CPU by the plain twin: z bit-equal, u8 within +-1, no outliers.

Prints one JSON line describing the kernels, then, as the last line,
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC_TOL = 1e-6


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


def kernel_vs_plain(spec, card):
    """Phase 3 for one scene: returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from dtrenderer_tpu_torch.ops import binning, pipeline, render_fused as rf

    sub = spec.submission(0.5)
    batch = pipeline.pack_draws(sub.draws, sub.view_proj, sub.light,
                                sub.sampling_mode, spec.width, spec.height,
                                near_clip=sub.near_clip)
    bins = binning.bin_triangles(batch.coef, batch.bbox, batch.valid,
                                 spec.height, spec.width, 0, 0, rf.TILE_H,
                                 rf.TILE_W)
    args = (batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
            spec.height, spec.width)
    z_k, src_k, _ = rf.render_fused(*args)
    z_p, src_p, _ = rf.render_fused_plain(*args)
    torch.cuda.synchronize()
    counts = (bins.tile_start[1:] - bins.tile_start[:-1])
    print(f"{spec.name} {spec.width}x{spec.height}: {batch.coef.shape[0]} "
          f"setup rows, {bins.tri_ids.shape[0]} (tile, tri) pairs, max bin "
          f"{int(counts.max())}")
    err = compare(f"{spec.name} kernel vs plain twin", z_k, src_k, z_p, src_p)
    # interleaved plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: rf.render_fused_plain(*args), 1)
    k1 = cuda_ms(lambda: rf.render_fused(*args), 20)
    k2 = cuda_ms(lambda: rf.render_fused(*args), 20)
    p2 = cuda_ms(lambda: rf.render_fused_plain(*args), 1)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    print(f"{spec.name}: kernel {k_ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
          f"twin {p_ms:.4f} ms ({p1:.4f}, {p2:.4f}) [{card}]")
    return err, k_ms, p_ms


def main_path(spec, frames: int, card):
    """Phase 4 for one scene: `frames` frames through spec.frame, each timed
    on the host clock up to a synchronise; checks every frame's output."""
    import torch

    from dtrenderer_tpu_torch.ops import fb as fblib

    dev = torch.device("cuda", 0)
    fb0 = fblib.create(spec.height, spec.width, dev)
    times = []
    for i in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, depth = spec.frame(fb0.color, fb0.depth, 0.5 + 0.1 * i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        covered = int(torch.isfinite(depth).sum())
        if covered <= 0:
            raise AssertionError(f"{spec.name} frame {i}: nothing covered")
        if not (bool(torch.isfinite(color).all())
                and color.shape == (spec.height, spec.width, 4)):
            raise AssertionError(f"{spec.name} frame {i}: bad colour plane")
    dt = min(times)
    print(f"{spec.name} main path: ms/frame "
          f"{', '.join(f'{t * 1e3:.3f}' for t in times)} (best "
          f"{dt * 1e3:.3f}), {covered / dt / 1e6:.1f} shaded Mpix/s, "
          f"{spec.n_tris / dt / 1e6:.2f} Mtris/s, covered px {covered} "
          f"[{card}]")


def stage_breakdown(spec, card):
    """Where one frame's time goes: each main-path stage timed on the host
    clock up to a synchronise (run after the counted main-path window)."""
    import torch

    from dtrenderer_tpu_torch.ops import binning, pipeline, render_fused as rf
    from dtrenderer_tpu_torch.ops import fb as fblib
    from dtrenderer_tpu_torch.utils.color import blend_over

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dev = torch.device("cuda", 0)
    fb = fblib.create(spec.height, spec.width, dev)
    sub = spec.submission(0.5)
    batch, t_vert = timed(lambda: pipeline.pack_draws(
        sub.draws, sub.view_proj, sub.light, sub.sampling_mode, spec.width,
        spec.height, near_clip=sub.near_clip))
    bins, t_bin = timed(lambda: binning.bin_triangles(
        batch.coef, batch.bbox, batch.valid, spec.height, spec.width, 0, 0,
        rf.TILE_H, rf.TILE_W))
    (z, src, _), t_k = timed(lambda: rf.render_fused(
        batch.coef, batch.payload, bins, batch.tex_lut, sub.light,
        spec.height, spec.width))
    _, t_merge = timed(lambda: (torch.where(
        (z < fb.depth)[..., None], blend_over(src, fb.color), fb.color),
        torch.where(z < fb.depth, z, fb.depth)))
    print(f"{spec.name} stages (ms): vertex+pack {t_vert:.3f}, binning "
          f"{t_bin:.3f}, render_fused {t_k:.3f}, merge {t_merge:.3f} [{card}]")


def reference_check():
    """Phase 6: small frames on the card vs the same frames on the CPU."""
    import torch

    from dtrenderer_tpu_torch.models import scenes
    from dtrenderer_tpu_torch.ops import fb as fblib

    for make, kw in ((scenes.make_config4, dict(width=160, height=120)),
                     (scenes.make_config5,
                      dict(width=256, height=128, n_tris=2000))):
        out = {}
        for dev in (torch.device("cuda", 0), torch.device("cpu")):
            spec = make(**kw, device=dev)
            fb0 = fblib.create(spec.height, spec.width, dev)
            out[dev.type] = spec.frame(fb0.color, fb0.depth, 0.6)
        compare(f"{spec.name} small, card vs CPU plain twin",
                out["cuda"][1], out["cuda"][0], out["cpu"][1], out["cpu"][0])


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "dtrenderer_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (dtrenderer_tpu_torch/ is missing)")
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

    from dtrenderer_tpu_torch.kernels import render_fused as k1
    from dtrenderer_tpu_torch.models import scenes
    from dtrenderer_tpu_torch.ops import render_fused as rf

    t0 = time.perf_counter()
    _, info = k1.library()
    print(f"build render_fused.cu: {time.perf_counter() - t0:.1f} s "
          f"(cached={info.cached})")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    if k1.tile_shape() != (rf.TILE_H, rf.TILE_W):
        raise AssertionError(f"kernel tile {k1.tile_shape()} != "
                             f"{(rf.TILE_H, rf.TILE_W)}")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cfg4 = scenes.make_config4(device=dev)
    cfg5 = scenes.make_config5(device=dev)
    print(f"scene set-up {time.perf_counter() - t0:.1f} s: config 4 "
          f"{cfg4.n_tris} tris, config 5 {cfg5.n_tris} tris")

    err4, ms4, plain4 = kernel_vs_plain(cfg4, card)
    err5, ms5, plain5 = kernel_vs_plain(cfg5, card)

    rf.KERNEL_LAUNCHES = 0
    main_path(cfg4, 3, card)
    main_path(cfg5, 2, card)
    launches = rf.KERNEL_LAUNCHES
    if launches != 5:
        raise AssertionError(f"main path launched K1 {launches} times for 5 "
                             f"frames (want one per frame)")
    print(f"K1 launches on the main path: {launches} for 5 frames")

    stage_breakdown(cfg4, card)
    stage_breakdown(cfg5, card)
    reference_check()

    report = {"kernels": [{
        "name": "render_fused",
        "route": "cuda",
        "source": "dtrenderer_tpu_torch/csrc/render_fused.cu",
        "replaces": "dtrenderer_tpu/ops/render_fused.py:269",
        "launches": launches,
        "max_abs_err": max(err4, err5),
        "ms": ms5,
        "plain_ms": plain5,
        "ms_config4_1080p": ms4,
        "plain_ms_config4_1080p": plain4,
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
