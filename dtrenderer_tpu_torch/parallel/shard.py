"""The band split of a frame over devices: framebuffer-domain decomposition
over a mesh of `torch.device`s, driven by one controller.

Port of `dtrenderer_tpu/parallel/shard.py`. The reference runs one program
per device under `shard_map`; here one Python thread loops over the mesh's
cells and enqueues each cell's work on that cell's device, on a CUDA stream
of the cell's own, so bands on different cards overlap and bands on one card
may. The streams are joined into each device's current stream when a draw
returns, so whatever the caller enqueues next (another draw, `gather_fb`) is
ordered after every band. Pixel ownership is disjoint, so no reduction across
devices is needed for z-buffering; assembling the image is one copy per band.

Axes of a mesh, as in the reference:
  "frames": data parallel over a batch of frames
  "rows":   the framebuffer cut into row bands
  "cols":   optional column bands (rows x cols = 2D tiles)

Deliberate differences from the reference:

- Devices may repeat in a mesh: on one card every cell is `cuda:0`, in the
  CPU tests every cell is `cpu`. `make_mesh` without `devices` takes every
  CUDA device, cycled over the cells, and never falls back to the CPU.
- A sharded framebuffer is a `ShardedFramebuffer`: per frame, a rows x cols
  grid of `Framebuffer` bands, each on its cell's device. `shard_fb` cuts a
  whole framebuffer, `gather_fb` assembles one.
- The scene inputs are moved, and the vertex stage runs, once per distinct
  device of the mesh and are shared by that device's bands
  (`draw_mesh_sharded`, `draw_mesh_ordered_sharded`). A caller's own band
  function (`render_frames_sharded`) calls `draw_mesh` itself, so there the
  vertex stage runs once per band.
- On a card a staged draw's batch is the memory of a CUDA graph
  (ops/vertex_graph.py), which the next replay of its key overwrites. The
  join above orders that replay after every band that reads the batch; a
  band job that replays on its own stream (`render_frames_sharded`) is
  ordered after the previous replay's stream by vertex_graph itself. The
  graph's key holds the addresses of the mesh and texture, so a scene
  tensor moved to another device is copied, on every draw, into the same
  copy there (`_mirror`), kept for as long as the tensor lives: the other
  cards replay their graphs as the scene's own card does.
- Host synchronisation inside a band's work (binning's `repeat_interleave`
  and bucket cuts, `rasterize_ref`'s `nonzero`) makes the one thread wait
  there, so bands whose route has such a point are enqueued one after the
  other whatever their streams.
"""

from __future__ import annotations

import inspect
import weakref
from typing import Sequence

import numpy as np
import torch

from dtrenderer_tpu_torch.ops import binning, fb as fblib, pipeline
from dtrenderer_tpu_torch.ops.fb import Framebuffer
from dtrenderer_tpu_torch.ops.render_fused import TILE_H, TILE_W

AXES = ("frames", "rows", "cols")


class BandMesh:
    """A [frames, rows, cols] grid of torch.device (devices may repeat)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is [frames, rows, cols], got a "
                             f"{devices.ndim}-d device array")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self._streams: dict = {}

    def device(self, frame: int, row: int, col: int) -> torch.device:
        return self.devices[frame, row, col]

    def distinct(self, frame: int = 0) -> list[torch.device]:
        """The distinct devices of one frame group, in cell order."""
        return list(dict.fromkeys(self.devices[frame].reshape(-1).tolist()))

    def stream(self, cell):
        """The CUDA stream of a cell (made at first use, then kept)."""
        if cell not in self._streams:
            self._streams[cell] = torch.cuda.Stream(device=self.devices[cell])
        return self._streams[cell]


def make_mesh(frames: int = 1, rows: int | None = None, cols: int = 1,
              devices: Sequence | None = None) -> BandMesh:
    """Build a ("frames", "rows", "cols") mesh of devices.

    devices: the devices to lay out, cycled over the frames * rows * cols
    cells; None takes every CUDA device and raises where there is none.
    rows defaults to n_devices // (frames * cols), at least 1. cols=1 is the
    pure row-band decomposition; cols > 1 tiles the frame 2D."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(devices=[torch.device('cpu')]) to run "
                               "elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: empty device list")
    if rows is None:
        rows = max(1, len(devices) // (frames * cols))
    n = frames * rows * cols
    if n < 1:
        raise ValueError(f"mesh {frames}x{rows}x{cols} has no cell")
    cells = np.empty(n, dtype=object)
    for i in range(n):
        cells[i] = devices[i % len(devices)]
    return BandMesh(cells.reshape(frames, rows, cols))


def _tile_dims(fb_hw, device_mesh: BandMesh):
    """(band_h, band_w) of each cell's tile; the mesh must divide the
    frame."""
    n_rows, n_cols = device_mesh.shape["rows"], device_mesh.shape["cols"]
    height, width = fb_hw
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by {n_rows} bands")
    if width % n_cols:
        raise ValueError(f"width {width} not divisible by {n_cols} columns")
    return height // n_rows, width // n_cols


class ShardedFramebuffer:
    """A framebuffer cut over a mesh: frames[i][r][c] is the Framebuffer of
    frame i's tile (r, c), [band_h, band_w], on its cell's device. batch is
    None for a single frame (frames has one entry, on frame group 0), else
    the number of frames, frame i on frame group i // (batch / n_frames)."""

    def __init__(self, mesh: BandMesh, height: int, width: int, frames,
                 batch: int | None = None):
        self.mesh, self.height, self.width = mesh, height, width
        self.frames, self.batch = frames, batch

    def group(self, i: int) -> int:
        """The mesh's frame group that holds frame i."""
        if self.batch is None:
            return 0
        return i // (self.batch // self.mesh.shape["frames"])


def _layout(height, width, mesh: BandMesh, batch):
    band_h, band_w = _tile_dims((height, width), mesh)
    if batch is not None and batch % mesh.shape["frames"]:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{mesh.shape['frames']} frame groups")
    return band_h, band_w, range(1 if batch is None else batch)


def create_sharded_fb(height: int, width: int, mesh: BandMesh,
                      batch: int | None = None) -> ShardedFramebuffer:
    """A cleared framebuffer (colour 0, depth +inf) cut rows over "rows" and
    columns over "cols"; with batch, that many frames over "frames"."""
    band_h, band_w, idx = _layout(height, width, mesh, batch)
    out = ShardedFramebuffer(mesh, height, width, None, batch)
    out.frames = [[[fblib.create(band_h, band_w,
                                 mesh.device(out.group(i), r, c))
                    for c in range(mesh.shape["cols"])]
                   for r in range(mesh.shape["rows"])] for i in idx]
    return out


def shard_fb(fb: Framebuffer, mesh: BandMesh) -> ShardedFramebuffer:
    """Cut a whole framebuffer (depth [H, W], or [B, H, W] for a batch) into
    the mesh's tiles, each on its cell's device (a row band that already
    lies there is a view of fb, not a copy)."""
    batched = fb.depth.dim() == 3
    height, width = fb.depth.shape[-2:]
    batch = fb.depth.shape[0] if batched else None
    band_h, band_w, idx = _layout(height, width, mesh, batch)
    out = ShardedFramebuffer(mesh, height, width, None, batch)

    def tile(i, r, c):
        ys = slice(r * band_h, (r + 1) * band_h)
        xs = slice(c * band_w, (c + 1) * band_w)
        color = fb.color[i] if batched else fb.color
        depth = fb.depth[i] if batched else fb.depth
        dev = mesh.device(out.group(i), r, c)
        return Framebuffer(color[ys, xs].to(dev).contiguous(),
                           depth[ys, xs].to(dev).contiguous())

    out.frames = [[[tile(i, r, c) for c in range(mesh.shape["cols"])]
                   for r in range(mesh.shape["rows"])] for i in idx]
    return out


def gather_fb(fb: ShardedFramebuffer, device=None) -> Framebuffer:
    """Assemble the whole framebuffer on one device (default: the first
    cell's): colour [H, W, 4] and depth [H, W], with a leading batch axis
    for a batched framebuffer."""
    device = fb.mesh.device(0, 0, 0) if device is None else torch.device(
        device)

    def plane(name):
        frames = [torch.cat([torch.cat([getattr(t, name).to(device)
                                        for t in row], dim=1)
                             for row in frame], dim=0)
                  for frame in fb.frames]
        return frames[0] if fb.batch is None else torch.stack(frames)

    return Framebuffer(color=plane("color"), depth=plane("depth"))


def gather_image(fb: ShardedFramebuffer) -> np.ndarray:
    """The whole frame's colour plane on the host."""
    return gather_fb(fb).color.cpu().numpy()


_MIRRORS: dict = {}  # (id(tensor), device) -> (weakref(tensor), its copy)


def _mirror(device: torch.device, src: torch.Tensor) -> torch.Tensor:
    """src's copy on `device`, refreshed from src on every call, in the same
    memory from call to call while src lives (and dropped with it), so that
    a key of ops/vertex_graph.py that holds its address recurs."""
    key = (id(src), str(device))
    hit = _MIRRORS.get(key)
    if hit is not None:
        ref, dst = hit
        if ref() is src and (dst.shape, dst.stride(), dst.dtype) == (
                src.shape, src.stride(), src.dtype):
            return dst.copy_(src)
    dst = torch.empty_like(src, device=device).copy_(src)
    _MIRRORS[key] = (weakref.ref(src, lambda _: _MIRRORS.pop(key, None)),
                     dst)
    return dst


def _here(t: torch.Tensor, device: torch.device) -> bool:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return t.device == device


def _to(device, obj):
    """obj with every tensor in it (through tuples, NamedTuples, lists and
    dicts) on `device`; tensors already there are not copied, the others
    are copied into their _mirror."""
    if isinstance(obj, torch.Tensor):
        return obj if _here(obj, device) else _mirror(device, obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(device, x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(device, x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to(device, v) for k, v in obj.items()}
    return obj


def _record(obj, stream):
    """Tell the allocator that `stream` will use the tensors in obj (made on
    a cell's stream, read later on the device's current stream)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _record(x, stream)


def _on_cells(mesh: BandMesh, jobs):
    """Run jobs = [(cell, fn)], cell = (frame group, row, col), as fn(device)
    in order; returns their results. A CUDA cell's job is enqueued on the
    cell's own stream, which first waits for the device's current stream
    (the scene inputs, a shared table); when all jobs are enqueued every
    current stream waits for its cells' streams."""
    mains, forks, results = {}, [], []
    for cell, fn in jobs:
        dev = mesh.devices[cell]
        if dev.type != "cuda":
            results.append(fn(dev))
            continue
        if dev not in mains:
            mains[dev] = torch.cuda.current_stream(dev)
        side = mesh.stream(cell)
        side.wait_stream(mains[dev])
        with torch.cuda.stream(side):
            out = fn(dev)
        _record(out, mains[dev])
        forks.append((mains[dev], side))
        results.append(out)
    for main, side in forks:
        main.wait_stream(side)
    return results


def _as_sharded(fb, device_mesh: BandMesh) -> ShardedFramebuffer:
    if isinstance(fb, Framebuffer):
        return shard_fb(fb, device_mesh)
    if fb.mesh is not device_mesh:
        raise ValueError("the framebuffer was cut over another mesh")
    return fb


def _draw_sharded(stage, fb, scene, device_mesh, kwargs):
    """Shared body of the two sharded draws: stage once per distinct device,
    raster once per tile."""
    fb = _as_sharded(fb, device_mesh)
    if fb.batch is not None:
        raise ValueError("a batched framebuffer goes through "
                         "render_frames_sharded")
    height, width = fb.height, fb.width
    band_h, band_w = _tile_dims((height, width), device_mesh)
    n_rows, n_cols = device_mesh.shape["rows"], device_mesh.shape["cols"]
    return_counters = kwargs.pop("return_counters", False)

    staged = {dev: stage(dev, *_to(dev, scene), height, width,
                         **_to(dev, kwargs))
              for dev in device_mesh.distinct()}
    row_dev = [device_mesh.device(0, r, 0) for r in range(n_rows)]
    bands = staged[row_dev[0]].bands
    band_bins = [None] * n_rows  # None: the tile bins for itself (per band)
    if bands.row_bands > 1:
        # cross-band binning: one table per device, or the band exchange
        if n_cols != 1:
            raise ValueError("shared cross-band binning shards rows only")
        if bands.row_bands != n_rows:
            raise ValueError(
                f"raster_opts row_bands ({bands.row_bands}) must equal the "
                f"mesh rows axis ({n_rows})")
        if bands.band_index is not None:
            raise ValueError("band_index is the mesh's to give: each row of "
                             "the mesh renders its own band")
        batches = [staged[d].batch for d in row_dev]
        if bands.distributed:
            band_bins = binning.bin_triangles_distributed(
                [b.bbox for b in batches], [b.valid for b in batches],
                height, width, n_rows, 0, 0, TILE_H, TILE_W)
        elif bands.shared:
            tables = {
                dev: binning.bin_triangles(
                    s.batch.coef, s.batch.bbox, s.batch.valid, height, width,
                    0, 0, TILE_H, TILE_W, n_rows)
                for dev, s in staged.items()}
            band_bins = [binning.band_bins(tables[d], r, n_rows)
                         for r, d in enumerate(row_dev)]

    def job(r, c):
        return lambda dev: pipeline.raster_staged(
            fb.frames[0][r][c], staged[dev], r * band_h, c * band_w,
            return_counters, band_bins[r])

    cells = [(r, c) for r in range(n_rows) for c in range(n_cols)]
    res = _on_cells(device_mesh, [((0, r, c), job(r, c)) for r, c in cells])
    tiles = [x[0] for x in res] if return_counters else res
    out = ShardedFramebuffer(
        device_mesh, height, width,
        [[tiles[r * n_cols:(r + 1) * n_cols] for r in range(n_rows)]])
    if not return_counters:
        return out
    return out, pipeline.merge_band_counters([x[1] for x in res])


def draw_mesh_sharded(fb, mesh_obj, model, view_proj, device_mesh: BandMesh,
                      **kwargs):
    """pipeline.draw_mesh over a row- (and optionally column-) sharded
    framebuffer, with draw_mesh's keywords. fb: a ShardedFramebuffer of
    `device_mesh` (or a whole Framebuffer, cut first); returns the drawn
    ShardedFramebuffer (and the frame's FrameCounters with
    return_counters=True: triangle counts once, pixels summed over tiles).

    The scene inputs go once to each distinct device of frame group 0, the
    vertex stage runs once there, and each tile rasters and shades only its
    own pixels. raster_opts (backend "fused") chooses the cross-band
    binning: none = each tile bins for itself; row_bands = the mesh's rows
    = one shared table per device, each band reading its window;
    band_distributed=True = the band exchange
    (binning.bin_triangles_distributed), band d's device binning the d-th
    slice of the triangles."""
    return _draw_sharded(pipeline.stage_draw_mesh, fb,
                         (mesh_obj, model, view_proj), device_mesh, kwargs)


def draw_mesh_ordered_sharded(fb, mesh_obj, model, view_proj,
                              device_mesh: BandMesh, **kwargs):
    """pipeline.draw_mesh_ordered (submission-order translucent blend and
    depth write) over a sharded framebuffer.

    Pixel ownership is disjoint, so submission order within a tile is the
    global order: each tile blends its triangles in order against its own
    slice of the incoming framebuffer, and the assembled image equals the
    single-device ordered render bit for bit."""
    return _draw_sharded(pipeline.stage_draw_mesh_ordered, fb,
                         (mesh_obj, model, view_proj), device_mesh, kwargs)


def render_frames_sharded(render_band_fn, fb: ShardedFramebuffer,
                          device_mesh: BandMesh,
                          frame_args) -> ShardedFramebuffer:
    """Batched multi-frame render: "frames" data parallel x "rows"/"cols"
    spatial.

    render_band_fn(band_fb, frame_arg, y0, frame_h, frame_w, x0=0) -> band_fb
    is a per-tile frame function (it can call pipeline.draw_mesh with the
    given offsets; its vertex stage then runs once per tile). Band functions
    of five parameters (no x0) are accepted: on a rows-only mesh x0 is
    always 0. fb: a batched framebuffer from create_sharded_fb(batch=...).
    frame_args: indexed by frame (a tensor or array with a leading [batch]
    axis, or a sequence of per-frame arguments); frame_args[i] is handed to
    each of frame i's tiles as it is (the band function puts it where it
    needs it). Where the reference vmaps over a device's frames, this
    loops."""
    fb = _as_sharded(fb, device_mesh)
    if fb.batch is None:
        raise ValueError("render_frames_sharded needs a batched "
                         "framebuffer (create_sharded_fb(batch=...))")
    height, width = fb.height, fb.width
    band_h, band_w = _tile_dims((height, width), device_mesh)
    n_rows, n_cols = device_mesh.shape["rows"], device_mesh.shape["cols"]
    try:
        takes_x0 = len(inspect.signature(render_band_fn).parameters) >= 6
    except (TypeError, ValueError):
        takes_x0 = False

    def job(i, r, c):
        arg = frame_args[i]
        tail = (c * band_w,) if takes_x0 else ()
        return lambda dev: Framebuffer(*render_band_fn(
            fb.frames[i][r][c], arg, r * band_h, height, width,
            *tail))

    cells = [(i, r, c) for i in range(fb.batch) for r in range(n_rows)
             for c in range(n_cols)]
    res = _on_cells(device_mesh, [((fb.group(i), r, c), job(i, r, c))
                                  for i, r, c in cells])
    per_frame = n_rows * n_cols
    frames = [[res[i * per_frame + r * n_cols:
                   i * per_frame + (r + 1) * n_cols]
               for r in range(n_rows)] for i in range(fb.batch)]
    return ShardedFramebuffer(device_mesh, height, width, frames, fb.batch)
