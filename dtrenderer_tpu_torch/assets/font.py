"""Font atlas baking (host-side asset prep).

Port of `dtrenderer_tpu/assets/font.py`. The atlas is a uniform ASCII grid
(16 columns x 6 rows, codes 32..126) of glyph coverage with per-glyph
advances, baked by the native TTF rasterizer (`assets/native.bake_font_file`)
and uploaded once; `ops/text.py` renders strings as gathers from it.

The built-in fonts are DejaVu Sans Mono ("mono") and DejaVu Sans ("sans").
The atlases the package itself uses (SHIPPED) are committed in
`builtin_fonts.npz`, baked from matplotlib's bundled DejaVu files by
`tools/bake_fonts.py`, so they render the same glyphs on a machine that has
no DejaVu file. Any other size is baked from a DejaVu TTF found on the
machine; when there is none, `bake_builtin_font` raises. There is no PIL
path and no substitute font.
"""

from __future__ import annotations

import functools
import importlib.util
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from dtrenderer_tpu_torch.assets import native
from dtrenderer_tpu_torch.utils import tensor_version

FIRST_CHAR = 32
LAST_CHAR = 126
GRID_COLS = 16
GRID_ROWS = 6  # 95 glyphs -> 6 rows of 16

# (size, family) of the atlases in builtin_fonts.npz: 12 mono is the default
# of api.render_text and DebugHud, 16 sans the demo's footer, the 14s the
# sizes the tests and the demo's HUD use.
SHIPPED = ((12, "mono"), (14, "mono"), (14, "sans"), (16, "sans"))
DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "builtin_fonts.npz")
TTF_NAMES = {"mono": "DejaVuSansMono.ttf", "sans": "DejaVuSans.ttf"}


class Font(NamedTuple):
    atlas: torch.Tensor  # f32 [GRID_ROWS*cell_h, GRID_COLS*cell_w] coverage
    cell_w: int
    cell_h: int
    advances: torch.Tensor | None = None  # f32 [95] advance (px), or None


# advances tensor -> (its version counter, f32 [95] on the host)
_HOST_ADVANCES = WeakIdKeyDictionary()


def host_advances(font: Font) -> np.ndarray:
    """The font's advances, f32 [95], on the host: kept from the bake, or
    copied from the tensor once (again only after an in-place edit of it),
    so that drawing text reads nothing back from the card. An inference
    tensor keeps no version counter, so it is read every time."""
    adv = font.advances
    version = tensor_version(adv)
    kept = _HOST_ADVANCES.get(adv)
    if kept is None or version is None or kept[0] != version:
        kept = (version, adv.detach().cpu().numpy().astype(np.float32))
        _HOST_ADVANCES[adv] = kept
    return kept[1]


def _font(atlas_u8, cell_w: int, cell_h: int, advances, device) -> Font:
    atlas = atlas_u8.astype(np.float32) / np.float32(255.0)
    advances = np.ascontiguousarray(advances, np.float32)
    adv = torch.from_numpy(advances).to(device)
    _HOST_ADVANCES[adv] = (tensor_version(adv), advances.copy())
    return Font(atlas=torch.from_numpy(atlas).to(device), cell_w=int(cell_w),
                cell_h=int(cell_h), advances=adv)


def bake_ttf_arrays(path: str, size: int):
    """(atlas u8 [H, W], cell_w, cell_h, advances f32 [95]) of a TTF file."""
    atlas_u8, cw, ch, metrics, _ascent = native.bake_font_file(
        path, float(size), FIRST_CHAR, LAST_CHAR - FIRST_CHAR + 1, GRID_COLS)
    return atlas_u8, cw, ch, np.ascontiguousarray(metrics[:, 0])


def bake_ttf(path: str, size: int, *, device) -> Font:
    """Bake any TTF file at the given pixel size."""
    return _font(*bake_ttf_arrays(path, size), device)


def _find_ttf(family: str) -> str | None:
    """A DejaVu file of `family` on this machine: matplotlib's bundled fonts
    (located without importing matplotlib), then the system's font
    directories."""
    dirs = []
    spec = importlib.util.find_spec("matplotlib")
    if spec is not None and spec.submodule_search_locations:
        dirs += [os.path.join(d, "mpl-data", "fonts", "ttf")
                 for d in spec.submodule_search_locations]
    dirs += ["/usr/share/fonts/truetype/dejavu", "/usr/share/fonts/dejavu",
             "/usr/share/fonts/TTF"]
    for d in dirs:
        path = os.path.join(d, TTF_NAMES[family])
        if os.path.isfile(path):
            return path
    return None


@functools.lru_cache(maxsize=1)
def _shipped():
    with np.load(DATA_PATH) as data:
        return {k: data[k] for k in data.files}


@functools.lru_cache(maxsize=16)
def _bake_builtin(size: int, family: str, device: torch.device) -> Font:
    if (size, family) in SHIPPED:
        d, key = _shipped(), f"{family}{size}"
        cw, ch = d[f"{key}_cell"]
        return _font(d[f"{key}_atlas"], cw, ch, d[f"{key}_advances"], device)
    path = _find_ttf(family)
    if path is None:
        raise FileNotFoundError(
            f"no {TTF_NAMES[family]} on this machine: the shipped built-in "
            f"atlases are {SHIPPED}; bake any other size from a TTF file "
            f"with bake_ttf(path, size)")
    return bake_ttf(path, size, device=device)


def bake_builtin_font(size: int = 14, family: str = "mono", *,
                      device) -> Font:
    """The built-in glyph atlas at the given pixel size on `device` (cached).

    family "mono" is DejaVu Sans Mono; "sans" is the PROPORTIONAL DejaVu
    Sans, whose per-glyph advances drive ops/text.draw_text_proportional.
    The atlas grid stays uniform cells (cell_w = max glyph width); only the
    advances differ."""
    if family not in TTF_NAMES:
        raise ValueError(f"unknown font family {family!r}")
    return _bake_builtin(int(size), family, torch.device(device))


def encode_text(s: str) -> np.ndarray:
    """String -> i32 glyph codes (unknown chars -> space)."""
    codes = np.frombuffer(s.encode("ascii", errors="replace"), dtype=np.uint8)
    codes = np.where((codes < FIRST_CHAR) | (codes > LAST_CHAR), FIRST_CHAR, codes)
    return codes.astype(np.int32)
