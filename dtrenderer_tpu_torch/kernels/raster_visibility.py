"""ctypes binding of the visibility raster kernel (csrc/raster_visibility.cu).

`launch` takes tensors the caller has already checked (ops/raster_pallas.py
does that) and enqueues one kernel on PyTorch's current CUDA stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "raster_visibility.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dtr_raster_visibility.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.dtr_raster_visibility.restype = ctypes.c_int
    lib.dtr_raster_visibility_tile_h.restype = ctypes.c_int
    lib.dtr_raster_visibility_tile_w.restype = ctypes.c_int
    return lib, info


def launch(coef, tile_start, tri_ids, z_out, tri_out, height: int,
           width: int, y_offset: int, x_offset: int) -> None:
    lib, _ = library()
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    err = lib.dtr_raster_visibility(
        coef.data_ptr(), tile_start.data_ptr(), tri_ids.data_ptr(),
        z_out.data_ptr(), tri_out.data_ptr(), height, width, y_offset,
        x_offset, stream)
    if err != 0:
        raise RuntimeError(
            f"raster_visibility kernel launch failed: cudaError {err}")


def tile_shape() -> tuple[int, int]:
    """The kernel's (tile_h, tile_w), as compiled."""
    lib, _ = library()
    return lib.dtr_raster_visibility_tile_h(), lib.dtr_raster_visibility_tile_w()
