"""Bitmap loading: native decode + the color pipeline's texture prep.

Port of `dtrenderer_tpu/assets/image.py`. Decoding runs in the dtr_native C++
library (the port's `assets/native.py`, ctypes + numpy). There is no PIL
fallback: when the native library is unavailable this raises.
"""

from __future__ import annotations

import torch

from dtrenderer_tpu_torch.assets import native
from dtrenderer_tpu_torch.utils.color import decode_srgb_u8


def load_bitmap(path: str, *, device):
    """Load an image file -> premultiplied linear f32 [H, W, 4] on `device`.

    The sRGB decode runs on the CPU and the texels are then copied, so the
    texture is bit-identical whichever device it lands on."""
    rgba = native.decode_image_file(path)
    return decode_srgb_u8(torch.from_numpy(rgba)).to(device)
