"""Bitmap loading: native decode + the color pipeline's texture prep.

Port of `dtrenderer_tpu/assets/image.py`. Decoding runs in the dtr_native C++
library (the port's `assets/native.py`, ctypes + numpy). There is no PIL
fallback: when the native library is unavailable this raises.
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.assets import native
from dtrenderer_tpu_torch.utils.color import decode_srgb_u8


def _texture(rgba_u8, premultiply_linear: bool, device):
    """The sRGB decode runs on the CPU and the texels are then copied, so the
    texture is bit-identical whichever device it lands on."""
    if not premultiply_linear:
        return rgba_u8
    return decode_srgb_u8(torch.from_numpy(rgba_u8)).to(device)


def load_bitmap(path: str, premultiply_linear: bool = True, *, device):
    """Load an image file -> premultiplied linear f32 [H, W, 4] on `device`
    (ready for sampling.sample), or the raw RGBA u8 numpy array [H, W, 4]
    when premultiply_linear=False."""
    return _texture(native.decode_image_file(path), premultiply_linear,
                    device)


def decode_bytes(data: bytes, premultiply_linear: bool = True, *, device):
    """load_bitmap for BMP/TGA/PNG bytes already in memory."""
    return _texture(native.decode_image_bytes(data), premultiply_linear,
                    device)
