"""Host platform layer: frame loop, input, hot reload, output.

Port of `dtrenderer_tpu/platform.py`: the platform owns an offscreen device
framebuffer, a scripted/programmatic input source, frame timing, PNG output,
and the hot-reload loop. `PlatformInput`/`RenderState` are the structs
crossing the boundary, `update(state, input) -> state` is the DTR_Update
analog, and hot reload (state survives, code swaps) is a module-mtime watch
+ re-exec of the module's file: the RenderState persists across code swaps.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import struct
import sys
import time
import zlib
from typing import Callable

from dtrenderer_tpu_torch.ops import fb as fblib


@dataclasses.dataclass
class PlatformInput:
    """Per-frame input (PlatformInput analog: keys w/ transition counts, mouse)."""
    delta_for_frame: float = 1.0 / 60.0
    time_now_s: float = 0.0
    keys_down: frozenset[str] = frozenset()
    keys_pressed: frozenset[str] = frozenset()  # went down this frame
    transition_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    mouse_x: int = 0
    mouse_y: int = 0
    mouse_buttons: frozenset[str] = frozenset()


class InputScript:
    """Deterministic scripted input source (headless stand-in for the message pump)."""

    def __init__(self, events: dict[int, dict] | None = None, dt: float = 1 / 60):
        self.events = events or {}
        self.dt = dt
        self._down: set[str] = set()
        self.frame = 0

    def next_frame(self) -> PlatformInput:
        ev = self.events.get(self.frame, {})
        pressed = set(ev.get("press", ()))
        released = set(ev.get("release", ()))
        self._down |= pressed
        self._down -= released
        counts: dict[str, int] = {}
        for k in pressed | released:
            counts[k] = counts.get(k, 0) + 1
        inp = PlatformInput(
            delta_for_frame=self.dt,
            time_now_s=self.frame * self.dt,
            keys_down=frozenset(self._down),
            keys_pressed=frozenset(pressed),
            transition_counts=counts,
            mouse_x=ev.get("mouse_x", 0),
            mouse_y=ev.get("mouse_y", 0),
            mouse_buttons=frozenset(ev.get("mouse_buttons", ())),
        )
        self.frame += 1
        return inp


class HotReloader:
    """Watch a module's source file; reload it when it changes (CS-4 analog)."""

    def __init__(self, module):
        self.module = module
        self.path = module.__file__
        self.mtime = os.path.getmtime(self.path)
        self.reload_count = 0

    def maybe_reload(self) -> bool:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return False
        if mtime == self.mtime:
            return False
        self.mtime = mtime
        # Re-exec from source (works for both package modules and file-loaded
        # scene scripts, unlike importlib.reload which needs an importable name).
        spec = importlib.util.spec_from_file_location(
            self.module.__name__, self.path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[self.module.__name__] = mod
        self.module = mod
        self.reload_count += 1
        return True


def run_app(
    update: Callable,
    state,
    n_frames: int,
    input_source: InputScript | None = None,
    reloader: HotReloader | None = None,
    update_attr: str = "update",
    on_frame: Callable | None = None,
    target_fps: float | None = None,
):
    """The main loop (CS-2 analog): poll input -> maybe hot reload -> update.

    update(state, PlatformInput) -> state is a host function that renders the
    frame. When `reloader` is given, `update` is re-fetched from the reloaded
    module via `update_attr` after each swap: `state` survives, code changes.
    Returns (final_state, frames_rendered, reloads).
    """
    input_source = input_source or InputScript()
    reloads = 0
    frame_budget = (1.0 / target_fps) if target_fps else None
    for i in range(n_frames):
        t0 = time.perf_counter()
        if reloader is not None and reloader.maybe_reload():
            update = getattr(reloader.module, update_attr)
            reloads += 1
        inp = input_source.next_frame()
        state = update(state, inp)
        if on_frame is not None:
            on_frame(i, state)
        if frame_budget is not None:
            # sleep-to-target-fps (reference CS-2: QPC timing + Sleep)
            remaining = frame_budget - (time.perf_counter() - t0)
            if remaining > 0:
                time.sleep(remaining)
    return state, n_frames, reloads


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def write_png(path: str, rgba_u8) -> None:
    """Write a u8 [H, W, 4] array (anything with .shape and .tobytes()) as an
    8-bit RGBA PNG: filter 0 on every row, one IDAT chunk."""
    h, w, c = rgba_u8.shape
    if c != 4:
        raise ValueError(f"write_png needs [H, W, 4], got {tuple(rgba_u8.shape)}")
    rows = rgba_u8.tobytes()
    stride = w * 4
    raw = b"".join(b"\x00" + rows[y * stride:(y + 1) * stride]
                   for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def present_png(state_or_fb, path: str) -> None:
    """Blit-to-screen analog: pack and write the framebuffer as PNG."""
    fb = getattr(state_or_fb, "fb", state_or_fb)
    write_png(path, fblib.pack(fb).cpu().numpy())
