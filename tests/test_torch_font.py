"""The port's font atlases (assets/font.py, the font binding of
assets/native.py) against the JAX package: the shipped atlases cannot drift
from the bake they were made by, a native bake is the same bake, and no
substitute font is drawn when no TTF can be found."""

import numpy as np
import pytest
import torch

from dtrenderer_tpu.assets import font as jfont
from dtrenderer_tpu.assets import native as jnative
from dtrenderer_tpu_torch.assets import font as pfont
from dtrenderer_tpu_torch.assets import native as pnative

CPU = torch.device("cpu")


@pytest.mark.parametrize("size,family", pfont.SHIPPED)
def test_shipped_atlas_bit_equal_to_the_jax_bake(size, family, monkeypatch):
    """Atlas, cell size and advances of each shipped atlas, bit for bit; it
    is loaded from the data file, not baked (the TTF search finds nothing
    here)."""
    monkeypatch.setattr(pfont, "_find_ttf", lambda family: None)
    pfont._bake_builtin.cache_clear()
    got = pfont.bake_builtin_font(size, family, device=CPU)
    want = jfont.bake_builtin_font(size, family=family)
    assert (got.cell_w, got.cell_h) == (want.cell_w, want.cell_h)
    assert got.atlas.dtype == torch.float32
    np.testing.assert_array_equal(got.atlas.numpy().view(np.int32),
                                  np.asarray(want.atlas).view(np.int32))
    np.testing.assert_array_equal(got.advances.numpy().view(np.int32),
                                  np.asarray(want.advances).view(np.int32))
    assert got.atlas.shape == (pfont.GRID_ROWS * got.cell_h,
                               pfont.GRID_COLS * got.cell_w)


def test_shipped_sizes_cover_the_packages_defaults():
    assert {(12, "mono"), (14, "mono"), (14, "sans"),
            (16, "sans")} == set(pfont.SHIPPED)


@pytest.mark.parametrize("family,name", [("mono", "DejaVu Sans Mono"),
                                         ("sans", "DejaVu Sans")])
def test_native_bake_bit_equal_to_the_jax_binding(family, name):
    """bake_font_file of the DejaVu file matplotlib bundles, through both
    packages' bindings; the port finds that same file without importing
    matplotlib."""
    import matplotlib.font_manager as fm

    ttf = jfont._find_ttf(name, "unused")
    assert ttf in [f.fname for f in fm.fontManager.ttflist]
    assert pfont._find_ttf(family) == ttf
    got = pnative.bake_font_file(ttf, 13.0)
    want = jnative.bake_font_file(ttf, 13.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # and the unshipped size bakes from that file into a Font
    pfont._bake_builtin.cache_clear()
    font = pfont.bake_builtin_font(13, family, device=CPU)
    np.testing.assert_array_equal(
        font.atlas.numpy(), got[0].astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(font.advances.numpy(), got[3][:, 0])
    baked = pfont.bake_ttf(ttf, 13, device=CPU)
    assert torch.equal(baked.atlas, font.atlas)


def test_unshipped_size_without_a_ttf_raises(monkeypatch):
    monkeypatch.setattr(pfont, "_find_ttf", lambda family: None)
    pfont._bake_builtin.cache_clear()
    with pytest.raises(FileNotFoundError, match="DejaVuSansMono.ttf"):
        pfont.bake_builtin_font(13, device=CPU)
    with pytest.raises(ValueError, match="family"):
        pfont.bake_builtin_font(12, "serif", device=CPU)
    pfont._bake_builtin.cache_clear()


def test_bad_ttf_raises(tmp_path):
    bad = tmp_path / "not_a_font.ttf"
    bad.write_bytes(b"this is no TrueType file")
    with pytest.raises(IOError, match="dtr_native font"):
        pnative.bake_font_file(str(bad), 12.0)


@pytest.mark.parametrize("s", ["plain ASCII ~!", "café ☃ tab\there",
                               "\x00\x1f\x7f", ""])
def test_encode_text_matches_jax(s):
    got, want = pfont.encode_text(s), jfont.encode_text(s)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ((got >= pfont.FIRST_CHAR) & (got <= pfont.LAST_CHAR)).all()


def test_grid_constants_match_jax():
    for k in ("FIRST_CHAR", "LAST_CHAR", "GRID_COLS", "GRID_ROWS"):
        assert getattr(pfont, k) == getattr(jfont, k)
