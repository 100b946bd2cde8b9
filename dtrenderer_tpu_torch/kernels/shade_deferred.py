"""ctypes binding of the deferred shading kernel (csrc/shade_deferred.cu).

`launch` takes tensors the caller has already checked (ops/pipeline.py
shade_deferred does that) and enqueues one kernel on PyTorch's current CUDA
stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "shade_deferred.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dtr_shade_deferred.argtypes = [p, p, p, p, p, p, p, p, p, p, f, f, f,
                                       i, i, i, i, i, i, p]
    lib.dtr_shade_deferred.restype = ctypes.c_int
    return lib, info


def launch(z, tri, depth, color, coef, attrs, tex_lut, scalars, out_color,
           out_depth, tw: int, th: int, flags: float, height: int,
           width: int, y_offset: int, x_offset: int) -> None:
    """attrs [T, 3, 10] with strides (row, 10, 1), any row >= 30."""
    lib, _ = library()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.dtr_shade_deferred(
        z.data_ptr(), tri.data_ptr(), depth.data_ptr(), color.data_ptr(),
        coef.data_ptr(), attrs.data_ptr(), tex_lut.data_ptr(),
        scalars.data_ptr(), out_color.data_ptr(), out_depth.data_ptr(),
        float(tw), float(th), float(flags), tex_lut.shape[0], attrs.stride(0),
        height, width, y_offset, x_offset, stream)
    if err != 0:
        raise RuntimeError(
            f"shade_deferred kernel launch failed: cudaError {err}")
