"""ctypes binding of the binning kernels (csrc/binning.cu).

`cover`, `pairs` and `sort_pairs` take tensors the caller has already
checked (ops/binning.py `bin_on_card` does that) and enqueue their work on
PyTorch's current CUDA stream of the tensors' device; none synchronises.
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
    lib.dtr_bin_cover.argtypes = [p, p, ll, i, i, i, i, i, i, i, p, p]
    lib.dtr_bin_pairs.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, p, p,
                                  p, p]
    lib.dtr_bin_sort.argtypes = [p, ctypes.POINTER(ctypes.c_size_t), p, p, p,
                                 p, i, i, p]
    for fn in (lib.dtr_bin_cover, lib.dtr_bin_pairs, lib.dtr_bin_sort):
        fn.restype = ctypes.c_int
    return lib, info


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, err):
    if err != 0:
        raise RuntimeError(f"binning {name} launch failed: cudaError {err}")


def cover(bbox, valid, grid, n_cover) -> None:
    """n_cover[t] (i64) = the tiles triangle t covers; grid = (height,
    width, y_offset, x_offset, tile_h, tile_w, row_bands)."""
    lib, _ = library()
    _check("cover", lib.dtr_bin_cover(
        bbox.data_ptr(), valid.data_ptr(), bbox.shape[0], *grid,
        n_cover.data_ptr(), _stream(bbox)))


def pairs(bbox, valid, ends, grid, tile_of, tri_of, counts) -> None:
    """Pair k's tile and triangle, in pair order; counts[1 + tile] += 1."""
    lib, _ = library()
    _check("pairs", lib.dtr_bin_pairs(
        bbox.data_ptr(), valid.data_ptr(), ends.data_ptr(), bbox.shape[0],
        tile_of.shape[0], *grid, tile_of.data_ptr(), tri_of.data_ptr(),
        counts.data_ptr(), _stream(bbox)))


def sort_pairs(keys, values, keys_out, values_out, end_bit: int) -> None:
    """Stable radix sort of (keys, values) by the keys' bits [0, end_bit)
    into (keys_out, values_out); the scratch is a torch tensor."""
    lib, _ = library()
    n = keys.shape[0]
    nbytes = ctypes.c_size_t(0)
    args = (keys.data_ptr(), keys_out.data_ptr(), values.data_ptr(),
            values_out.data_ptr(), n, end_bit, _stream(keys))
    _check("sort (scratch size)", lib.dtr_bin_sort(None, ctypes.byref(nbytes),
                                                   *args))
    temp = torch.empty(max(1, nbytes.value), dtype=torch.uint8,
                       device=keys.device)
    _check("sort", lib.dtr_bin_sort(temp.data_ptr(), ctypes.byref(nbytes),
                                    *args))
