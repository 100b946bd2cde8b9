"""ctypes binding of the binning kernels (csrc/binning.cu).

`scan` and `emit` take tensors the caller has already checked
(ops/binning.py `bin_on_card` does that) and enqueue their work on
PyTorch's current CUDA stream of the tensors' device; neither
synchronises. `budget` and `scratch_bytes` launch nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "binning.cu"


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dtr_bin_budget.argtypes = []
    lib.dtr_bin_scan.argtypes = [p, p, ll, i, i, i, i, i, i, i, p, p]
    lib.dtr_bin_scratch_bytes.argtypes = [ll, i, i, i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_size_t)]
    lib.dtr_bin_emit.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p,
                                 ctypes.c_size_t, p, p, p]
    for fn in (lib.dtr_bin_budget, lib.dtr_bin_scan, lib.dtr_bin_scratch_bytes,
               lib.dtr_bin_emit):
        fn.restype = ctypes.c_int
    return lib, info


@functools.lru_cache(maxsize=1)
def budget() -> int:
    """Triangles a scan block takes (one status word each in `work`)."""
    return library()[0].dtr_bin_budget()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, err):
    if err != 0:
        raise RuntimeError(f"binning {name} launch failed: cudaError {err}")


def scan(bbox, valid, grid, work) -> None:
    """work (i64 [T + 2 + ceil(T / budget())]): the pairs' ends [T], the
    pair count P, the look-back's status words and ticket (cleared here);
    grid = (height, width, y_offset, x_offset, tile_h, tile_w, row_bands)."""
    lib, _ = library()
    _check("scan", lib.dtr_bin_scan(
        bbox.data_ptr(), valid.data_ptr(), bbox.shape[0], *grid,
        work.data_ptr(), _stream(bbox)))


def scratch_bytes(n_pairs: int, grid) -> int:
    """Bytes of the scratch `emit` needs (CUB's own and the unsorted
    pairs): a query on the host."""
    lib, _ = library()
    nbytes = ctypes.c_size_t(0)
    _check("scratch size", lib.dtr_bin_scratch_bytes(n_pairs, *grid,
                                                     ctypes.byref(nbytes)))
    return nbytes.value


def emit(bbox, valid, work, n_pairs: int, grid, scratch, tile_start,
         tri_ids) -> None:
    """The pairs of `work`'s ends, stably sorted by tile into tri_ids
    (i32 [n_pairs]), and tile_start (i32 [n_tiles + 2]: the CSR offsets,
    then the overflow word 0)."""
    lib, _ = library()
    _check("emit", lib.dtr_bin_emit(
        bbox.data_ptr(), valid.data_ptr(), work.data_ptr(), bbox.shape[0],
        n_pairs, *grid, scratch.data_ptr(), scratch.numel(),
        tile_start.data_ptr(), tri_ids.data_ptr(), _stream(bbox)))
