"""ctypes binding of the vertex-stage kernel (csrc/vertex_pass.cu).

`launch` takes tensors the caller has already checked (ops/vertex_batch.py
`run_pass` does that) and enqueues one kernel on PyTorch's current CUDA
stream, which a CUDA graph's capture records like any other launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "vertex_pass.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dtr_vertex_pass.argtypes = [p, p, i, ll, p, p, i, i, i, i, i, p, p,
                                    p, p, p]
    lib.dtr_vertex_pass.restype = ctypes.c_int
    lib.dtr_vertex_pass_table_cols.restype = ctypes.c_int
    return lib, info


def launch(table, heads, vec, mvps, coef, bbox, valid, payload,
           n_tris: int, light_at: int, width: int, height: int,
           cull_backfaces: bool, near_clip: bool) -> None:
    lib, _ = library()
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    err = lib.dtr_vertex_pass(
        table.data_ptr(), heads.data_ptr(), table.shape[0], n_tris,
        vec.data_ptr(), mvps.data_ptr(), light_at, width, height,
        int(cull_backfaces), int(near_clip), coef.data_ptr(), bbox.data_ptr(),
        valid.data_ptr(), payload.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vertex_pass kernel launch failed: cudaError {err}")


def table_cols() -> int:
    """The columns of the per-draw table, as compiled."""
    lib, _ = library()
    return lib.dtr_vertex_pass_table_cols()
