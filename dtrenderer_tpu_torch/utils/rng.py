"""PCG32 random number generator (host + device).

Port of `dtrenderer_tpu/utils/rng.py`. Two implementations of the SAME
stream:

- `Pcg32`: sequential host-side generator (the reference-shaped API).
- `pcg32_stream`: counter-based device evaluation. state_i is computed in
  closed form via LCG jumps (state_i = A^i * s0 + (sum_{j<i} A^j) * inc mod
  2^64, with the jump coefficients precomputed host-side), so all n outputs
  evaluate in parallel on the device with no sequential dependency. The
  64-bit arithmetic runs in int64, whose multiply and add wrap mod 2^64;
  every right shift is masked, because `>>` on a negative int64
  sign-extends. Host and device agree bit for bit.

For bulk device randomness prefer torch's generators; this exists for
reference-API parity and deterministic demo content.
"""

from __future__ import annotations

import numpy as np
import torch

_MULT = 6364136223846793005
_INC_DEFAULT = 1442695040888963407
_M64 = (1 << 64) - 1


class Pcg32:
    """Host-side PCG32 (XSH-RR variant)."""

    def __init__(self, seed: int = 0x853C49E6748FEA9B, inc: int | None = None):
        self.inc = np.uint64((inc if inc is not None else _INC_DEFAULT) | 1)
        self.state = np.uint64(0)
        self.next_u32()
        self.state = np.uint64((int(self.state) + int(np.uint64(seed))) % (1 << 64))
        self.next_u32()

    def next_u32(self) -> int:
        old = self.state
        self.state = np.uint64(
            (int(old) * _MULT + int(self.inc)) % (1 << 64)
        )
        xorshifted = np.uint32(((int(old) >> 18) ^ int(old)) >> 27 & 0xFFFFFFFF)
        rot = int(old) >> 59
        return int(np.uint32((int(xorshifted) >> rot) | (int(xorshifted) << ((-rot) & 31)) & 0xFFFFFFFF))

    def next_f32(self) -> float:
        """Uniform [0, 1) with 24 bits of mantissa (DqnRnd_F32-style)."""
        return (self.next_u32() >> 8) * (1.0 / (1 << 24))

    def range_i32(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) (simple modulo, like the reference)."""
        return lo + self.next_u32() % max(hi - lo, 1)


def _signed(x: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


def _shr(x, k: int):
    """Logical right shift of an int64 tensor holding a u64 pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def pcg32_stream(seed: int, n: int, inc: int | None = None, *, device):
    """First n PCG32 outputs for `seed` (a Python int, full 64 bits),
    evaluated in parallel on `device`.

    Returns int64 [n] holding the u32 values, equal to
    [Pcg32(seed).next_u32() for _ in range(n)] (torch has no arithmetic on
    uint32; `.to(torch.uint32)` or numpy's `.astype(np.uint32)` narrows
    without loss). The LCG jump coefficients A^i and sum_{j<i} A^j * inc are
    host data, so the per-element work is one multiply-add plus the XSH-RR
    output permutation.
    """
    inc_v = ((inc if inc is not None else _INC_DEFAULT) | 1) & _M64
    a_pow, c_inc = [], []
    ap, s = 1, 0
    for _ in range(n):
        a_pow.append(_signed(ap))
        c_inc.append(_signed(s * inc_v))
        s = (s * _MULT + 1) & _M64
        ap = (ap * _MULT) & _M64
    jumps = torch.tensor([a_pow, c_inc], dtype=torch.int64, device=device)
    # Pcg32.__init__: state = A*(inc + seed) + inc  (mod 2^64), exact on the
    # host in Python ints
    s0 = _signed(_MULT * (inc_v + (int(seed) & _M64)) + inc_v)

    state = jumps[0] * s0 + jumps[1]  # state_i = A^i * s0 + C_i, wraps
    # XSH-RR: ((state ^ (state >> 18)) >> 27) rotated right by (state >> 59)
    xorshifted = _shr(_shr(state, 18) ^ state, 27) & 0xFFFFFFFF
    rot = _shr(state, 59)
    return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) \
        & 0xFFFFFFFF


def pcg32_f32_stream(seed: int, n: int, inc: int | None = None, *, device):
    """First n uniform [0,1) f32 draws (24-bit mantissa), device-parallel."""
    u = pcg32_stream(seed, n, inc, device=device)
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
