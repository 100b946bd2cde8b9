"""ctypes binding of the fused raster+shade kernel (csrc/render_fused.cu).

`launch` takes tensors the caller has already checked (ops/render_fused.py
does that) and enqueues one kernel on PyTorch's current CUDA stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "render_fused.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dtr_render_fused.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.dtr_render_fused.restype = ctypes.c_int
    lib.dtr_render_fused_tile_h.restype = ctypes.c_int
    lib.dtr_render_fused_tile_w.restype = ctypes.c_int
    return lib, info


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch(coef, payload, tile_start, tri_ids, tex_lut, scalars, z_out,
           src_out, height: int, width: int, y_offset: int,
           x_offset: int, *, fb_color=None, fb_depth=None, out_color=None,
           out_depth=None, shaded=None) -> None:
    """Without fb_depth the kernel writes z_out and src_out; with it (and
    fb_color, out_color, out_depth; z_out and src_out None) the merged
    framebuffer, and the winners are added to `shaded` (i32 [], or None)."""
    lib, _ = library()
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    err = lib.dtr_render_fused(
        coef.data_ptr(), payload.data_ptr(), tile_start.data_ptr(),
        tri_ids.data_ptr(), tex_lut.data_ptr(), scalars.data_ptr(),
        _ptr(z_out), _ptr(src_out), _ptr(fb_color), _ptr(fb_depth),
        _ptr(out_color), _ptr(out_depth), _ptr(shaded), tex_lut.shape[0],
        height, width, y_offset, x_offset, stream)
    if err != 0:
        raise RuntimeError(f"render_fused kernel launch failed: cudaError {err}")


def tile_shape() -> tuple[int, int]:
    """The kernel's (tile_h, tile_w), as compiled."""
    lib, _ = library()
    return lib.dtr_render_fused_tile_h(), lib.dtr_render_fused_tile_w()
