"""ctypes bindings to the dtr_native C++ asset library (OBJ parse, image
decode, TTF atlas bake).

The port's own copy of `dtrenderer_tpu/assets/native.py`: the same C ABI of
the committed `native/libdtr_native.so` (built from `native/dtr_native.cpp`
and `native/dtr_font.cpp` with `make -C native`), so both packages parse,
decode and bake bit-identically. There is no fallback: when the library
cannot be loaded, every call raises.
"""

from __future__ import annotations

import ctypes as C
import functools
import os

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libdtr_native.so",
)


class _ObjData(C.Structure):
    _fields_ = [
        ("positions", C.POINTER(C.c_float)),
        ("uvs", C.POINTER(C.c_float)),
        ("normals", C.POINTER(C.c_float)),
        ("pos_idx", C.POINTER(C.c_int64)),
        ("uv_idx", C.POINTER(C.c_int64)),
        ("n_idx", C.POINTER(C.c_int64)),
        ("n_positions", C.c_int64),
        ("n_uvs", C.c_int64),
        ("n_normals", C.c_int64),
        ("n_tris", C.c_int64),
        ("has_uv", C.c_int32),
        ("has_n", C.c_int32),
        ("error", C.c_char * 256),
    ]


class _Image(C.Structure):
    _fields_ = [
        ("pixels", C.POINTER(C.c_uint8)),
        ("width", C.c_int32),
        ("height", C.c_int32),
        ("error", C.c_char * 256),
    ]


class _FontAtlas(C.Structure):
    _fields_ = [
        ("atlas", C.POINTER(C.c_uint8)),
        ("atlas_w", C.c_int32),
        ("atlas_h", C.c_int32),
        ("cell_w", C.c_int32),
        ("cell_h", C.c_int32),
        ("first_char", C.c_int32),
        ("num_chars", C.c_int32),
        ("grid_cols", C.c_int32),
        ("metrics", C.POINTER(C.c_float)),
        ("ascent_px", C.c_float),
        ("error", C.c_char * 256),
    ]


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        lib = C.CDLL(LIB_PATH)
    except OSError as e:
        raise ImportError(
            f"cannot load {LIB_PATH} ({e}); build it with `make -C native`"
        ) from e
    lib.dtr_obj_parse_file.restype = C.POINTER(_ObjData)
    lib.dtr_obj_parse_file.argtypes = [C.c_char_p]
    lib.dtr_obj_parse.restype = C.POINTER(_ObjData)
    lib.dtr_obj_parse.argtypes = [C.c_char_p, C.c_int64]
    lib.dtr_obj_free.argtypes = [C.POINTER(_ObjData)]
    lib.dtr_image_decode.restype = C.POINTER(_Image)
    lib.dtr_image_decode.argtypes = [C.c_char_p, C.c_int64]
    lib.dtr_image_free.argtypes = [C.POINTER(_Image)]
    lib.dtr_font_bake_file.restype = C.POINTER(_FontAtlas)
    lib.dtr_font_bake_file.argtypes = [C.c_char_p, C.c_float,
                                       C.c_int32, C.c_int32, C.c_int32]
    lib.dtr_font_free.argtypes = [C.POINTER(_FontAtlas)]
    return lib


def available() -> bool:
    """Whether native/libdtr_native.so loads. A query only: the port has no
    other path to fall back to, so every call below raises without it."""
    try:
        _lib()
    except ImportError:
        return False
    return True


def _copy(ptr, count, dtype):
    if count == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def _obj_to_arrays(lib, dp):
    d = dp.contents
    try:
        err = d.error.decode()
        if err:
            raise IOError(f"dtr_native obj: {err}")
        positions = _copy(d.positions, d.n_positions * 3, np.float32).reshape(-1, 3)
        uvs = _copy(d.uvs, d.n_uvs * 2, np.float32).reshape(-1, 2)
        normals = _copy(d.normals, d.n_normals * 3, np.float32).reshape(-1, 3)
        pos_idx = _copy(d.pos_idx, d.n_tris * 3, np.int64).reshape(-1, 3)
        uv_idx = _copy(d.uv_idx, d.n_tris * 3, np.int64).reshape(-1, 3)
        n_idx = _copy(d.n_idx, d.n_tris * 3, np.int64).reshape(-1, 3)
        has_uv = bool(d.has_uv)
        has_n = bool(d.has_n)
    finally:
        lib.dtr_obj_free(dp)
    return (
        positions,
        uvs if has_uv else None,
        normals if has_n else None,
        pos_idx,
        uv_idx if has_uv else None,
        n_idx if has_n else None,
    )


def parse_obj_file(path: str):
    """Native OBJ parse -> (positions [Nv,3], uvs [Nt,2] or None, normals
    [Nn,3] or None, pos_idx [T,3], uv_idx [T,3] or None, n_idx [T,3] or
    None), the tuple of assets.obj.parse_obj_text."""
    lib = _lib()
    return _obj_to_arrays(lib, lib.dtr_obj_parse_file(path.encode()))


def parse_obj_bytes(data: bytes):
    """parse_obj_file on the bytes of an OBJ file."""
    lib = _lib()
    return _obj_to_arrays(lib, lib.dtr_obj_parse(data, len(data)))


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode BMP/TGA/PNG bytes -> RGBA u8 [H, W, 4] (top-down)."""
    lib = _lib()
    ip = lib.dtr_image_decode(data, len(data))
    im = ip.contents
    try:
        err = im.error.decode()
        if err:
            raise IOError(f"dtr_native image: {err}")
        arr = _copy(im.pixels, im.width * im.height * 4, np.uint8).reshape(
            im.height, im.width, 4
        )
    finally:
        lib.dtr_image_free(ip)
    return arr


def decode_image_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def bake_font_file(path: str, pixel_size: float, first_char: int = 32,
                   num_chars: int = 95, grid_cols: int = 16):
    """Bake a TTF glyph atlas natively.

    Returns (atlas u8 [H, W] coverage, cell_w, cell_h, metrics f32
    [num_chars, 4] (advance, bearing_x, baseline_y, used), ascent_px).
    """
    lib = _lib()
    ap = lib.dtr_font_bake_file(path.encode(), pixel_size, first_char,
                                num_chars, grid_cols)
    a = ap.contents
    try:
        err = a.error.decode()
        if err:
            raise IOError(f"dtr_native font: {err}")
        atlas = _copy(a.atlas, a.atlas_w * a.atlas_h, np.uint8).reshape(
            a.atlas_h, a.atlas_w
        )
        metrics = _copy(a.metrics, a.num_chars * 4, np.float32).reshape(-1, 4)
        out = (atlas, int(a.cell_w), int(a.cell_h), metrics, float(a.ascent_px))
    finally:
        lib.dtr_font_free(ap)
    return out
