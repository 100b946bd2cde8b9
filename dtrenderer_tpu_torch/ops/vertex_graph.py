"""The batched vertex pass of ops/vertex_batch.py as a CUDA graph per
submission key, replayed frame after frame.

`pack` is what `pipeline.pack_draws` calls on a CUDA device. A submission's
key (`submission_key`) holds all that decides the pass's ops and the
addresses they read: the device, each draw's shading mode, sampling flag,
whether a normal matrix is given and where its colour lives, the shape,
strides, dtype and address of each mesh tensor and texture (and which draws
share a texture), whether mvps are given, the frame size and the cull and
near-clip flags. The values of matrices, light and colours are not in it:
they are copied into the graph's one input vector before each replay.

The gain rests on one property of the traffic: a program submits the same
runs of draws, with meshes and textures at the same addresses, frame after
frame. Each device's `Keys` sees that property as it is, with no count of
keys to guess:

- First sighting of a key: the pass runs eager (`vertex_batch.pack`, the
  pass uncached, what a replay is held against) and only the key is kept,
  among the SEEN most recent first sightings; no plan, no device memory.
- Second sighting, however many other keys came between: the key's plan is
  made, a warm-up pass runs on the device's side stream, then the capture
  on that stream, then the first replay.
- Later sightings: one `torch.cat` of the frame's matrices and light into
  the input vector, one host-to-device copy of the colours given on the
  host (when there are any), one replay.

A captured key stays while it recurs: it is dropped (its graph and pool with
it) once it has gone unseen for more than twice the longest gap, in calls on
its device, between two of its sightings, checked once every as many calls
as there are captured keys (so a call pays for one check on average). A
program whose frames repeat N submissions thus keeps N graphs, for any N; a
key that stops being drawn goes within about three of its frames.

A failed capture raises; there is no eager fallback on the card. The
returned DrawBatch is the graph's memory until the next replay of its key
(pipeline.pack_draws says who may read it when; `Stamp` tells a holder
whether it still may). A replay on another stream than the previous replay
of its key first waits for that stream, which covers band jobs that replay
on streams of their own (parallel/shard.py). `stats()` reads what each
captured key did.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

from dtrenderer_tpu_torch.ops import vertex_batch

F32 = torch.float32
SEEN = 4096  # first sightings remembered per device: keys only

# sightings on the card, all keys together
EAGER = 0
CAPTURES = 0
REPLAYS = 0


def _sig(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.stride(), t.dtype, t.data_ptr())


def submission_key(draws, view_proj, light, sampling_mode: str,
                   frame_w: int, frame_h: int, cull_backfaces: bool = True,
                   near_clip: bool = True, mvps=None) -> tuple:
    """The key of a run of DrawSpecs (plain Python, no device work): equal
    keys mean the same ops on the same addresses, whatever the values of
    view_proj, the draws' matrices, the light and the colours."""
    device = light.direction.device
    shared: dict = {}
    per_draw = []
    for i, d in enumerate(draws):
        tex = None
        if d.texture is not None:
            tex = (_sig(d.texture), shared.setdefault(id(d.texture), i))
        per_draw.append((
            d.shading, (d.sampling or sampling_mode) == "bilinear",
            d.normal_mat is not None, vertex_batch.color_on(d.color, device),
            tuple(_sig(t) for t in d.mesh), tex))
    return (str(device), int(frame_w), int(frame_h), bool(cull_backfaces),
            bool(near_clip), mvps is not None, tuple(per_draw))


class _Entry:
    """A captured key: its sightings, and once captured its plan, graph,
    input vector and output batch."""

    def __init__(self, period: int, seen: int):
        self.period = period  # the longest gap between two sightings
        self.seen = seen      # the call of the last sighting
        self.plan = self.graph = self.vec = self.out = None
        self.stream = None    # the stream of the last replay
        self.replays = 0
        self.pool_bytes = 0


class Keys:
    """One device's keys (plain Python): the recent first sightings and the
    captured entries, by the rules of the module's docstring."""

    def __init__(self, seen_max: int = SEEN):
        self.clock = 0              # calls on the device
        self.first = OrderedDict()  # key -> call of its first sighting
        self.live: dict = {}        # key -> _Entry
        self.seen_max = seen_max
        self.sweep_at = 0           # the call of the next check for stale keys
        self.side = None            # the CUDA stream of warm-ups and captures

    def sight(self, key) -> _Entry | None:
        """Count one call of `key`: None on a first sighting (run the pass
        eager); else its entry, new (graph None: capture it) or captured
        (replay it)."""
        self.clock += 1
        if self.clock >= self.sweep_at:
            for k in [k for k, e in self.live.items()
                      if self.clock - e.seen > 2 * e.period]:
                del self.live[k]
            self.sweep_at = self.clock + max(1, len(self.live))
        entry = self.live.get(key)
        if entry is not None:
            entry.period = max(entry.period, self.clock - entry.seen)
            entry.seen = self.clock
            return entry
        first = self.first.pop(key, None)
        if first is None:
            self.first[key] = self.clock
            if len(self.first) > self.seen_max:
                self.first.popitem(last=False)
            return None
        entry = self.live[key] = _Entry(self.clock - first, self.clock)
        return entry


_CACHE: dict = {}  # str(device) -> Keys
_OWNER = weakref.WeakValueDictionary()  # id(entry.out) -> entry


class Stamp:
    """Which replay made a DrawBatch (`stamp`): `check` raises once a later
    replay of the same key has overwritten it."""

    def __init__(self, entry: _Entry):
        self.entry, self.replays = entry, entry.replays

    def check(self):
        if self.entry.replays != self.replays:
            raise RuntimeError(
                "this draw's vertex stage was overwritten by a later replay "
                "of the same submission (ops/vertex_graph.py): raster a "
                "staged draw before staging the same draw again, or stage "
                "it again")


def stamp(batch) -> Stamp | None:
    """The Stamp of a DrawBatch that a replay returned; None for any other
    (an eager batch is the caller's own)."""
    entry = _OWNER.get(id(batch))
    return Stamp(entry) if entry is not None and entry.out is batch else None


def _fill(entry: _Entry, draws, view_proj, light, mvps):
    """Copy one frame's values into the entry's input vector (on the
    current stream)."""
    tensors, host = vertex_batch.frame_inputs(entry.plan, draws, view_proj,
                                              light, mvps)
    n_dev = entry.vec.numel() - host.numel()
    torch.cat(tensors, out=entry.vec[:n_dev])
    if host.numel():
        entry.vec[n_dev:].copy_(host)


def _capture(entry: _Entry, side, draws, view_proj, light, mvps):
    """Warm up and capture the entry's pass on the device's side stream.
    The graph is driven by hand, not by `torch.cuda.graph`, whose entry
    synchronises the device and empties the allocator's cache."""
    plan = entry.plan
    device = plan.device
    entry.vec = torch.empty(plan.n_inputs, dtype=F32, device=device)
    _fill(entry, draws, view_proj, light, mvps)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(side):
        vertex_batch.run_pass(plan, entry.vec, draws)  # warm-up
        # the capture's private pool starts empty, so every byte it
        # reserves is a new segment: the reserved count's rise is the pool
        before = torch.cuda.memory_reserved(device)
        graph.capture_begin()
        try:
            out = vertex_batch.run_pass(plan, entry.vec, draws)
        finally:
            graph.capture_end()
        entry.pool_bytes = torch.cuda.memory_reserved(device) - before
    main.wait_stream(side)
    entry.graph, entry.out = graph, out
    _OWNER[id(out)] = entry


def pack(draws, view_proj, light, sampling_mode: str, frame_w: int,
         frame_h: int, cull_backfaces: bool = True, near_clip: bool = True,
         mvps=None):
    """pipeline.pack_draws on a CUDA device: eager, captured or replayed by
    the key's sightings (the module's docstring)."""
    global EAGER, CAPTURES, REPLAYS
    key = submission_key(draws, view_proj, light, sampling_mode, frame_w,
                         frame_h, cull_backfaces, near_clip, mvps)
    device = light.direction.device
    keys = _CACHE.setdefault(str(device), Keys())
    entry = keys.sight(key)
    if entry is None:
        EAGER += 1
        return vertex_batch.pack(draws, view_proj, light, sampling_mode,
                                 frame_w, frame_h, cull_backfaces, near_clip,
                                 mvps)
    stream = torch.cuda.current_stream(device)
    if entry.graph is None:
        entry.plan = vertex_batch.plan_run(
            draws, sampling_mode, frame_w, frame_h, cull_backfaces,
            near_clip, mvps is not None, device)
        if keys.side is None:  # one side stream a device, so that the
            keys.side = torch.cuda.Stream(device)  # warm-ups reuse blocks
        _capture(entry, keys.side, draws, view_proj, light, mvps)
        CAPTURES += 1
    elif entry.stream is not None and entry.stream != stream:
        stream.wait_stream(entry.stream)
    _fill(entry, draws, view_proj, light, mvps)
    entry.graph.replay()
    entry.stream = stream
    entry.replays += 1
    REPLAYS += 1
    return entry.out


def device_keys(device) -> Keys | None:
    """The Keys of a device (None before its first call)."""
    return _CACHE.get(str(device))


def stats() -> list[dict]:
    """Per captured key: its device, draws, setup rows and frame size, its
    period (the longest gap between two sightings, in calls on its
    device), its replays and the bytes its capture reserved (the graph's
    pool)."""
    out = []
    for device, keys in _CACHE.items():
        for entry in keys.live.values():
            p = entry.plan
            if p is None:
                continue
            out.append(dict(
                device=device, draws=p.n_draws, rows=p.n_rows,
                frame=(p.frame_w, p.frame_h), period=entry.period,
                replays=entry.replays, pool_mib=entry.pool_bytes / 2**20))
    return out


def reset():
    """Drop every key (its plan, graph and pool) and zero the counts."""
    global EAGER, CAPTURES, REPLAYS
    _CACHE.clear()
    EAGER = CAPTURES = REPLAYS = 0
