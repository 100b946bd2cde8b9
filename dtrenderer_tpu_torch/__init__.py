"""dtrenderer_tpu_torch — the PyTorch/CUDA port of the JAX package.

The module layout mirrors `dtrenderer_tpu/` so each counterpart is easy to
find. Plain tensor code is eager PyTorch; each kernel the JAX package wrote
in Pallas is a hand-written CUDA C++ kernel for Hopper, built with nvcc at
first use: the fused raster+shade kernel (`csrc/render_fused.cu`), the
visibility kernel (`csrc/raster_visibility.cu`) and the ordered translucency
kernel (`csrc/render_ordered.cu`), which share their device code
(`csrc/raster_common.cuh`). On top of the draw pipeline (`ops/pipeline.py`)
sit the 2D primitives and text (`ops/draw2d.py`, `ops/text.py`, the font
atlases of `assets/font.py`), the public verbs on a `RenderState` (`api.py`),
the debug HUD (`debug.py`), the platform loop (`platform.py`) and the demo
and scene tools (`tools/`), all plain torch. Every function that creates
tensors takes an explicit `device`. The package never imports JAX; the JAX package stays the
reference it is tested against (FORMULAS.md holds the op-order contract both
follow).
"""

__version__ = "0.1.0"
