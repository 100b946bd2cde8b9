"""dtrenderer_tpu_torch — the PyTorch/CUDA port of dtrenderer_tpu.

The module layout mirrors `dtrenderer_tpu/` so each counterpart is easy to
find. Plain tensor code is eager PyTorch; the one kernel of the opaque draw
path (the fused raster+shade kernel) is hand-written CUDA C++ for Hopper
(`csrc/render_fused.cu`), built with nvcc at first use. Every function that
creates tensors takes an explicit `device`. The package never imports JAX;
the JAX package stays the reference it is tested against (FORMULAS.md holds
the op-order contract both follow).
"""

__version__ = "0.1.0"
