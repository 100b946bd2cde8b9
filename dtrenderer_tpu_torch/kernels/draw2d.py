"""ctypes binding of the 2D verb kernel (csrc/draw2d.cu, D2).

`launch` takes a verb (ops/draw2d.py Verb) and colour planes the caller has
already checked (ops/draw2d.py draw does that) and enqueues its kernel on
PyTorch's current CUDA stream; `triangle` enqueues the G-buffer of
api.render_triangle's triangle. The verb's constants go by value in the
launch: nothing is copied to the card and nothing is read back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dtrenderer_tpu_torch import kernels

SOURCE = "draw2d.cu"
N_PARAMS = 15  # floats of a shape's or a blit's constants


@functools.lru_cache(maxsize=1)
def library():
    """Build (at first use) and load the kernel library. Returns
    (ctypes.CDLL, kernels.BuildInfo)."""
    lib, info = kernels.load(SOURCE)
    bind(lib)
    return lib, info


def bind(lib) -> None:
    """Argument and result types of the entry points (the card's build, or
    the tests' host build of the same source)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dtr_draw2d_shape.argtypes = [i, p, p, p, i, i, p, p]
    lib.dtr_draw2d_blit.argtypes = [p, p, i, i, p, p, i, i, p, p]
    lib.dtr_draw2d_text.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p]
    lib.dtr_draw2d_triangle.argtypes = [p, p, p, p, p, p, i, i, p, p]
    for fn in (lib.dtr_draw2d_shape, lib.dtr_draw2d_blit, lib.dtr_draw2d_text,
               lib.dtr_draw2d_triangle, lib.dtr_draw2d_max_glyphs):
        fn.restype = ctypes.c_int


def _floats(values, n: int):
    return (ctypes.c_float * n)(*values, *([0.0] * (n - len(values))))


def _ints(values):
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def _copy(arr: np.ndarray, ctype):
    """A ctypes array holding a copy of a (non-empty) numpy array's values."""
    return (ctype * arr.size).from_buffer_copy(arr)


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"draw2d kernel launch ({what}) failed: "
                           f"cudaError {err}")


def glyph_cells(codes: np.ndarray, cell_w: int, cell_h: int):
    """Each glyph's atlas cell corner (column, row) in int32 as ops/text.py
    computes it: code - FIRST_CHAR, floor-divided by and taken modulo
    GRID_COLS, times the cell size, wrapping as int32 does."""
    from dtrenderer_tpu_torch.assets.font import FIRST_CHAR, GRID_COLS

    with np.errstate(over="ignore"):
        code = codes.astype(np.int32) - np.int32(FIRST_CHAR)
        ox = (code % np.int32(GRID_COLS)) * np.int32(cell_w)
        oy = (code // np.int32(GRID_COLS)) * np.int32(cell_h)
    return ox.astype(np.int32), oy.astype(np.int32)


def launch(verb, color, out, lib=None) -> int:
    """One verb from colour plane `color` into `out` (both f32 [H, W, 4],
    contiguous, 16-byte aligned; every pixel of `out` is written, outside
    the verb's window as a copy): the calls of `calls`, each checked.
    Returns the launches made: 1, or one per kMaxGlyphs glyphs of a longer
    string."""
    made = calls(verb, color, out, lib)
    for fn, args in made:
        _check(fn(*args), fn.__name__)
    return len(made)


def calls(verb, color, out, lib=None) -> list:
    """The kernel entry calls that draw `verb`, as (ctypes function,
    arguments), ready to make (and to make again: chip_smoke.py times the
    card with them). lib: another build of the same entry points (the
    tests' host build), which gets stream 0."""
    from dtrenderer_tpu_torch.ops import draw2d

    if lib is None:
        lib = library()[0]
        stream = torch.cuda.current_stream(color.device).cuda_stream
    else:
        stream = 0
    frame = (color.shape[0], color.shape[1], _ints(verb.window), stream)
    if verb.kind == draw2d.BLIT:
        image = verb.image
        return [(lib.dtr_draw2d_blit, (
            _floats(verb.params, N_PARAMS), image.data_ptr(), image.shape[0],
            image.shape[1], color.data_ptr(), out.data_ptr(), *frame))]
    if verb.kind == draw2d.TEXT:
        return _text_calls(lib, verb, color, out, frame)
    return [(lib.dtr_draw2d_shape, (
        verb.kind, _floats(verb.params, N_PARAMS), color.data_ptr(),
        out.data_ptr(), *frame))]


def _text_calls(lib, verb, color, out, frame) -> list:
    """A string in runs of at most kMaxGlyphs glyphs, each placed as the
    whole string places it: glyph columns do not overlap, so the runs'
    launches, each after the last over its output, draw what one launch
    would."""
    run, atlas = verb.text, verb.image
    ox, oy = glyph_cells(run.codes, run.cell_w, run.cell_h)
    n, step = run.codes.shape[0], lib.dtr_draw2d_max_glyphs()
    col = _floats(verb.params, 4)
    made = []
    for s in range(0, n, step):
        e = min(s + step, n)
        if run.bounds is None:  # shift the origin by the glyphs before
            x0 = run.x0 + s * run.cell_w * run.scale
            x0 = (x0 + 2 ** 31) % 2 ** 32 - 2 ** 31
            bounds = _floats((), 1)
        else:
            x0 = run.x0
            bounds = _copy(run.bounds[s:e + 1], ctypes.c_float)
        ints = _ints((x0, run.y0, run.scale, run.cell_w, run.cell_h, e - s,
                      atlas.shape[1], atlas.shape[0],
                      run.bounds is not None))
        src = color if s == 0 else out
        made.append((lib.dtr_draw2d_text, (
            col, ints, _copy(ox[s:e], ctypes.c_int),
            _copy(oy[s:e], ctypes.c_int), bounds, atlas.data_ptr(),
            src.data_ptr(), out.data_ptr(), *frame)))
    return made


def triangle(coef, attrs, window, z, tri, coef_out, attrs_out,
             lib=None) -> None:
    """api.render_triangle's G-buffer: coef f32 [16] and attrs f32 [3, 10]
    on the host; z f32 and tri i32 [H, W], coef_out [1, 16] and attrs_out
    [1, 3, 10] on the card, all written. lib: as launch's."""
    if lib is None:
        lib = library()[0]
        stream = torch.cuda.current_stream(z.device).cuda_stream
    else:
        stream = 0
    h, w = z.shape
    _check(lib.dtr_draw2d_triangle(
        _floats(coef.tolist(), 16), _floats(attrs.reshape(-1).tolist(), 30),
        z.data_ptr(), tri.data_ptr(), coef_out.data_ptr(),
        attrs_out.data_ptr(), h, w, _ints(window), stream), "triangle")
