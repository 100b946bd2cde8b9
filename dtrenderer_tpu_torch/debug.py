"""Frame counters.

Port of `FrameCounters` from `dtrenderer_tpu/debug.py` (the HUD is not ported
yet). Counters are 0-dim int32 tensors on the frame's device, so reading them
is the caller's choice of when to synchronise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameCounters(NamedTuple):
    """Per-frame counters. bin_overflow counts (tile, triangle) pairs dropped
    by binning; the port's binning drops nothing, so it stays 0."""
    tris_submitted: torch.Tensor
    tris_valid: torch.Tensor
    pixels_shaded: torch.Tensor
    bin_overflow: torch.Tensor

    @staticmethod
    def zero(device) -> "FrameCounters":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return FrameCounters(z, z, z, z)

    def merge(self, other: "FrameCounters") -> "FrameCounters":
        return FrameCounters(
            self.tris_submitted + other.tris_submitted,
            self.tris_valid + other.tris_valid,
            self.pixels_shaded + other.pixels_shaded,
            self.bin_overflow + other.bin_overflow,
        )
