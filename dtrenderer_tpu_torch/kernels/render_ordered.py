"""ctypes binding of the ordered translucency kernel (csrc/render_ordered.cu).

`launch` takes tensors the caller has already checked (ops/raster_ordered.py
does that) and enqueues one kernel on PyTorch's current CUDA stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "render_ordered.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dtr_render_ordered.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, p]
    lib.dtr_render_ordered.restype = ctypes.c_int
    lib.dtr_render_ordered_tile_h.restype = ctypes.c_int
    lib.dtr_render_ordered_tile_w.restype = ctypes.c_int
    return lib, info


def launch(coef, payload, tile_start, tri_ids, tex_lut, scalars, color_in,
           depth_in, color_out, depth_out, height: int, width: int,
           y_offset: int, x_offset: int) -> None:
    lib, _ = library()
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    err = lib.dtr_render_ordered(
        coef.data_ptr(), payload.data_ptr(), tile_start.data_ptr(),
        tri_ids.data_ptr(), tex_lut.data_ptr(), scalars.data_ptr(),
        color_in.data_ptr(), depth_in.data_ptr(), color_out.data_ptr(),
        depth_out.data_ptr(), tex_lut.shape[0], height, width, y_offset,
        x_offset, stream)
    if err != 0:
        raise RuntimeError(
            f"render_ordered kernel launch failed: cudaError {err}")


def tile_shape() -> tuple[int, int]:
    """The kernel's (tile_h, tile_w), as compiled."""
    lib, _ = library()
    return lib.dtr_render_ordered_tile_h(), lib.dtr_render_ordered_tile_w()
