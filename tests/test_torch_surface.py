"""The port's public surface against the reference's.

  * every public top-level name of a module of `dtrenderer_tpu/` (function,
    class or assignment, read from the source with `ast`) has a namesake in
    the same module of `dtrenderer_tpu_torch/`, except the names listed in
    LEFT_BEHIND: TPU-only machinery that ROADMAP.md "Leave behind" keeps out
    of the port, the layout elisions of ROADMAP queue 1 item 6, and
    constants that only the reference's TPU code reads. A name added to the
    reference without a counterpart fails here;
  * the last three names ported: `primitives.plane`, `assets/native
    .available` and `.parse_obj_bytes`, each against the reference.
"""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

LEFT_BEHIND = {
    # ROADMAP "Leave behind": the binning-mode zoo (the port's CSR bins
    # always carry the id) and the budgets of the TPU's bins
    "ops/binning": {"FlatBins", "SETUP_ID_CHANNEL", "bin_triangles_flat",
                    "bin_triangles_flat_distributed"},
    "ops/render_fused": {
        "prepare_draw_bins", "render_fused_band_distributed",
        "render_fused_rowbands", "auto_shard_budget", "band_pair_budget",
        "DEFAULT_RASTER_OPTS", "dummy_texture_lut",
        # VMEM texture ceilings and the routing they drive
        "TEX_BUDGET_TEXELS", "TEX_LUT_MAX_TEXELS",
        # slot_k, measured a wash on the TPU
        "SLOT_K",
        # the payload layout elisions (ROADMAP queue 1 item 6): the port
        # packs the full 34 channels
        "PayloadLayout", "FULL_LAYOUT", "plan_layout",
        # Mosaic's chunking and id sentinel
        "CHUNK", "INT_MAX"},
    "ops/raster_pallas": {"CHUNK", "INT_MAX"},
    "ops/raster_ordered": {"I32", "INT_MAX"},
    # the lane index of inv_area2 in the reference's channel-major setup
    "ops/geometry": {"CH_INV_AREA2"},
    # the reference pads attrs to 16 lanes for the deferred pass
    "ops/pipeline": {"ATTR_CHANNELS"},
    "ops/sampling": {"F32"},
    # the TPU build stamp
    "utils/hwgate": {"*"},
}


def _public_names(package: str) -> dict:
    """{module path relative to the package: public top-level names}."""
    root = os.path.join(REPO, package)
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for f in filenames:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, "/")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            names = set()
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    names.add(node.name)
                elif isinstance(node, ast.Assign):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
                elif (isinstance(node, ast.AnnAssign)
                      and isinstance(node.target, ast.Name)):
                    names.add(node.target.id)
            out[mod] = {n for n in names if not n.startswith("_")}
    return out


def test_every_public_name_of_the_reference_is_ported_or_left_behind():
    ref = _public_names("dtrenderer_tpu")
    port = _public_names("dtrenderer_tpu_torch")
    missing = {}
    for mod, names in ref.items():
        gone = names - port.get(mod, set())
        if gone:
            missing[mod] = gone if mod in port else {"*"}
    assert missing == LEFT_BEHIND


def test_plane_bit_equal_to_reference():
    from dtrenderer_tpu.models import primitives as jprim
    from dtrenderer_tpu_torch.models import primitives as pprim

    for size in (1.0, 2.5):
        ref, got = jprim.plane(size), pprim.plane(size, device=CPU)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert got.faces.dtype == torch.int64 and got.num_tris == 2


def test_native_library_is_available():
    from dtrenderer_tpu_torch.assets import native

    assert native.available()


def _same_tuple(a, b):
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_parse_obj_bytes_matches_reference_and_parse_obj_file():
    from dtrenderer_tpu.assets import native as jnative
    from dtrenderer_tpu_torch.assets import native

    path = os.path.join(REPO, "data", "head.obj")
    with open(path, "rb") as f:
        data = f.read()
    got = native.parse_obj_bytes(data)
    assert got[3].shape[0] > 1000
    _same_tuple(got, jnative.parse_obj_bytes(data))
    _same_tuple(got, native.parse_obj_file(path))
    tri = b"v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nf 1/1 2/1 3/1\n"
    _same_tuple(native.parse_obj_bytes(tri), jnative.parse_obj_bytes(tri))


def test_parse_obj_file_reports_the_parsers_error():
    """The error the library writes (it fails only to open a file) raises,
    through the conversion parse_obj_bytes shares."""
    from dtrenderer_tpu_torch.assets import native

    with pytest.raises(IOError, match="dtr_native obj: cannot open"):
        native.parse_obj_file(os.path.join(REPO, "data", "missing.obj"))


def test_native_available_is_false_without_the_library(monkeypatch):
    from dtrenderer_tpu_torch.assets import native

    monkeypatch.setattr(native, "LIB_PATH", os.path.join(REPO, "missing.so"))
    native._lib.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(ImportError, match="make -C native"):
            native.parse_obj_bytes(b"v 0 0 0\n")
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
    assert native.available()
