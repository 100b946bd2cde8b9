"""PyTorch port's fused raster+shade vs the JAX reference's render_fused.

Scenes are built in screen space with numpy from a seed: corners
(sx, sy, sz, q) and raw corner attributes (u, v, rgba, normal). Both
packages get the same coef (the port's setup, which equals the reference's
bit for bit, test_torch_ops.py), the same full 34-channel payload and the
same texels; the reference runs its Pallas kernel in interpret mode, as its
own tests do on the CPU.

The `gpu` tests compare the CUDA kernel with its plain twin on the card. The
card's machine has no JAX, so they run without this repo's conftest.py:
    python -m pytest --noconftest -m gpu tests/test_torch_render_fused.py

Bars:
  * against the NumPy scalar oracle (tests/oracle.py, FORMULAS.md with no
    FMA): z equal bit for bit;
  * against the reference's interpret-mode kernel: the same covered pixels,
    packed u8 within +-1 with zero outliers, and f32 z and src within
    FMA-contraction noise. XLA:CPU contracts mul+add into FMA inside the
    reference's compiled kernel body, and the port (plain twin here,
    `--fmad=false` on the card) does not; ARCHITECTURE.md "Correctness chain"
    puts that noise at ~1e-4 relative in depth. Measured on these scenes:
    on random soups like these, z up to 1073 ulp (6.4e-5 relative) and src
    up to 3.8e-5, both in phong+bilinear cases.
"""

import numpy as np
import pytest
import torch

import oracle
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch.models import stress
from dtrenderer_tpu_torch.ops import binning as pbin
from dtrenderer_tpu_torch.ops import geometry as pgeo
from dtrenderer_tpu_torch.ops import render_fused as prf
from dtrenderer_tpu_torch.ops.shading import Light, make_light

CPU = torch.device("cpu")
H, W = 64, 128
LUT_LANES = 384  # one padded LUT width for every case: one reference compile
Z_REL = 1e-4     # FMA-contraction noise (module docstring)
SRC_ABS = 1e-4
LIGHT = make_light((0.4, 0.6, 1.0), 0.15, device=CPU)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several pytest workers on a few cores; torch's
    intra-op pool in each of them would oversubscribe the cores, and these
    small eager tensors gain nothing from it. Values do not depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checker(size, cells):
    ij = np.arange(size) * cells // size
    mask = ((ij[:, None] + ij[None, :]) % 2)[..., None].astype(bool)
    return np.where(mask, np.float32([0.9, 0.3, 0.2, 1.0]),
                    np.float32([0.2, 0.5, 0.9, 1.0])).astype(np.float32)


def _gradient(size):
    u = np.linspace(0, 1, size, dtype=np.float32)
    r, g = np.meshgrid(u, u, indexing="xy")
    return np.stack([r, g, 1.0 - r * g, np.ones_like(r)], -1)


def _triangles(rng, n, size):
    """n random screen-space triangles with their raw attributes."""
    c = np.zeros((n, 3, 4), np.float32)
    centre = rng.uniform([-8, -8], [W + 8, H + 8], (n, 1, 2))
    c[..., :2] = centre + rng.uniform(-size, size, (n, 3, 2))
    c[..., 2] = rng.uniform(0.05, 0.95, (n, 3))
    c[..., 3] = rng.uniform(0.2, 2.0, (n, 3))
    raw = np.zeros((n, 3, 9), np.float32)
    raw[..., 0:2] = rng.uniform(-0.1, 1.1, (n, 3, 2))
    raw[..., 2:5] = rng.uniform(0.1, 1.0, (n, 3, 3))
    raw[..., 5] = rng.uniform(0.5, 1.0, (n, 3))
    raw[..., 6:9] = rng.normal(size=(n, 3, 3))
    return c, raw


def _attrs10(c, raw):
    q = c[..., 3:4]
    return np.concatenate([q, raw * q], -1).astype(np.float32)


# case -> list of draws (seed, n, size, texture or None, phong, bilinear)
CASES = {
    "nearest": [(1, 60, 14, "checker", False, False)],
    "bilinear": [(2, 60, 14, "gradient", False, True)],
    "phong_bilinear": [(3, 60, 14, "checker", True, True)],
    "phong_untextured": [(4, 60, 14, None, True, False)],
    "mixed_modes": [(5, 40, 14, "checker", False, False),
                    (6, 40, 14, "gradient", True, True),
                    (7, 30, 10, None, False, True)],
    "overlap_ties": [(8, 160, 40, "gradient", True, True)],
}


def _build(case):
    """-> (corners [T,3,4], coef, bbox, valid, payload [T,34], lut [L,4])
    as numpy, the payload packed by the port's pack_payload."""
    texs = {"checker": _checker(16, 4), "gradient": _gradient(8)}
    textures, corners, attrs, flags = [], [], [], []
    for seed, n, size, tex, phong, bil in CASES[case]:
        c, raw = _triangles(np.random.default_rng(seed), n, size)
        if case == "overlap_ties":
            # every triangle again, later in submission order: exact z
            # ties, which the (min z, min id) rule gives to the first copy
            raw2 = raw.copy()
            raw2[..., 2:5] = 1.0 - raw2[..., 2:5]
            c, raw = np.concatenate([c, c]), np.concatenate([raw, raw2])
        corners.append(c)
        attrs.append(_attrs10(c, raw))
        textures.append(convert.texture(texs[tex], CPU) if tex else
                        torch.ones((1, 1, 4)))
        flags.append(prf.pack_flags(phong, bil))
    lut, meta = prf.make_texture_lut(textures)
    payload = torch.cat([prf.pack_payload(convert.tensor(a, CPU), m, f)
                         for a, m, f in zip(attrs, meta, flags)])
    c = np.concatenate(corners)
    t = convert.tensor(c, CPU)
    setup = pgeo.triangle_setup_from_corners(t[:, 0], t[:, 1], t[:, 2], W, H,
                                             cull_backfaces=False)
    return (c, setup.coef.numpy(), setup.bbox.numpy(), setup.valid.numpy(),
            payload.numpy(), lut.numpy())


def _reference(coef, bbox, valid, payload, lut):
    # JAX is imported here, not at the top: the gpu test below runs on the
    # card's machine, which has no JAX.
    import jax.numpy as jnp
    from dtrenderer_tpu.ops import render_fused as jrf

    lut_j = np.zeros((4, LUT_LANES), np.float32)
    lut_j[:, :lut.shape[0]] = lut.T
    z, src, overflow = jrf.render_fused(
        jnp.asarray(coef), jnp.asarray(bbox), jnp.asarray(valid),
        jnp.asarray(payload), jnp.asarray(lut_j),
        jnp.asarray(LIGHT.direction.numpy()),
        jnp.asarray(LIGHT.ambient.numpy()), H, W,
        bilinear=jrf.SAMPLE_MIXED, with_phong=True, capacity=512,
        small_span=16, broad_cap=128)
    assert int(overflow) == 0
    return np.asarray(z), np.asarray(src)


def _port(coef, bbox, valid, payload, lut, device=CPU, plain=False,
          shard=(0, 0, H, W)):
    """shard = (y_offset, x_offset, height, width) of the rendered region."""
    y0, x0, h, w = shard
    t = lambda a, dt=np.float32: convert.tensor(a, device, dt)  # noqa: E731
    coef_t = t(coef)
    bins = pbin.bin_triangles(coef_t, t(bbox, np.int32), t(valid, bool), h, w,
                              y0, x0)
    fn = prf.render_fused_plain if plain else prf.render_fused
    z, src, overflow = fn(coef_t, t(payload), bins, t(lut),
                          _light(device), h, w, y0, x0)
    assert int(overflow) == 0
    return z.cpu().numpy(), src.cpu().numpy()


def _light(device):
    return Light(LIGHT.direction.to(device), LIGHT.ambient.to(device))


def _pack(src):
    return np.floor(np.clip(src, 0.0, 1.0) * 255.0 + 0.5).astype(int)


def _oracle_z(corners):
    screen = corners.reshape(-1, 4)
    faces = np.arange(screen.shape[0]).reshape(-1, 3)
    z, _ = oracle.rasterize(screen, faces, H, W, cull_backfaces=False)
    return z


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_twin_matches_reference(case):
    corners, coef, bbox, valid, payload, lut = _build(case)
    z_p, src_p = _port(coef, bbox, valid, payload, lut)
    z_r, src_r = _reference(coef, bbox, valid, payload, lut)

    covered = np.isfinite(z_r)
    np.testing.assert_array_equal(np.isfinite(z_p), covered)
    assert covered.sum() > 200, "scene covers too little to test"
    np.testing.assert_allclose(z_p[covered], z_r[covered], rtol=Z_REL, atol=0)
    assert np.all(src_p[~covered] == 0)
    assert np.abs(src_p - src_r).max() <= SRC_ABS
    du8 = np.abs(_pack(src_p) - _pack(src_r))
    assert du8.max() <= 1, f"{(du8 > 1).sum()} u8 outliers"


@pytest.mark.parametrize("case", ["nearest", "mixed_modes", "overlap_ties"])
def test_plain_twin_depth_matches_oracle_bit_exact(case):
    """Without FMA on either side, depth is FORMULAS.md bit for bit."""
    corners, coef, bbox, valid, payload, lut = _build(case)
    z_p, _ = _port(coef, bbox, valid, payload, lut)
    np.testing.assert_array_equal(z_p.view(np.int32),
                                  _oracle_z(corners).view(np.int32))


def test_exact_depth_ties_go_to_the_lowest_id():
    """Every triangle of overlap_ties is submitted twice with other colours:
    dropping the later copies must not change one bit of the image."""
    corners, coef, bbox, valid, payload, lut = _build("overlap_ties")
    n = coef.shape[0] // 2
    z_all, src_all = _port(coef, bbox, valid, payload, lut)
    z_first, src_first = _port(coef[:n], bbox[:n], valid[:n], payload[:n],
                               lut)
    np.testing.assert_array_equal(z_all.view(np.int32),
                                  z_first.view(np.int32))
    np.testing.assert_array_equal(src_all.view(np.int32),
                                  src_first.view(np.int32))
    assert np.isfinite(z_all).sum() > 1000


def test_render_fused_dispatch_on_cpu_is_the_plain_twin():
    corners, coef, bbox, valid, payload, lut = _build("mixed_modes")
    before = prf.KERNEL_LAUNCHES
    z_a, src_a = _port(coef, bbox, valid, payload, lut)
    z_b, src_b = _port(coef, bbox, valid, payload, lut, plain=True)
    assert prf.KERNEL_LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_array_equal(z_a, z_b)
    np.testing.assert_array_equal(src_a, src_b)
    coef_t = convert.tensor(coef, CPU)
    bins = pbin.bin_triangles(coef_t, convert.tensor(bbox, CPU, np.int32),
                              convert.tensor(valid, CPU, bool), H, W)
    with pytest.raises(ValueError, match="payload"):
        prf.render_fused(coef_t, torch.zeros((1, 34)), bins,
                         convert.tensor(lut, CPU), _light(CPU),
                         H, W)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_twin_on_gpu(case):
    """The CUDA kernel against its plain twin on the card: z bit-equal,
    src within 1e-6, packed u8 within +-1 (run: pytest -m gpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    corners, coef, bbox, valid, payload, lut = _build(case)
    before = prf.KERNEL_LAUNCHES
    z_k, src_k = _port(coef, bbox, valid, payload, lut, device=dev)
    assert prf.KERNEL_LAUNCHES == before + 1
    z_p, src_p = _port(coef, bbox, valid, payload, lut, device=dev,
                       plain=True)
    np.testing.assert_array_equal(z_k.view(np.int32), z_p.view(np.int32))
    assert np.abs(src_k - src_p).max() <= 1e-6
    assert np.abs(_pack(src_k) - _pack(src_p)).max() <= 1


@pytest.mark.gpu
def test_kernel_matches_plain_twin_on_gpu_in_shards():
    """Shards of the frame (non-zero y/x offsets, ragged edge tiles) on the
    card: kernel == plain twin == the same window of the CPU frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    args = _build("mixed_modes")[1:]
    z_full, src_full = _port(*args)
    for y0, x0, h, w in ((0, 0, 40, 100), (24, 37, 40, 91), (5, 0, 17, 128)):
        z_k, src_k = _port(*args, device=dev, shard=(y0, x0, h, w))
        z_p, src_p = _port(*args, device=dev, plain=True,
                           shard=(y0, x0, h, w))
        np.testing.assert_array_equal(z_k.view(np.int32), z_p.view(np.int32))
        np.testing.assert_array_equal(src_k.view(np.int32),
                                      src_p.view(np.int32))
        np.testing.assert_array_equal(
            z_k.view(np.int32), z_full[y0:y0 + h, x0:x0 + w].view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(stress.CASES))
def test_kernel_matches_plain_twin_on_gpu_stress(case):
    """What the scenes' shapes do not reach on the card: a tile of more
    than 512 triangles (three staging chunks), shared edges through pixel
    centres and along sub-block borders, and shards whose size is no
    multiple of the tile or the sub-block at non-zero offsets. z and src
    bit-equal to the plain twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    corners, h, w = stress.CASES[case]()
    setup = stress.setup(corners, h, w, dev)
    payload, lut = stress.payload(corners, 5, dev)
    for y0, x0, bh, bw in stress.windows(h, w):
        bins = pbin.bin_triangles(setup.coef, setup.bbox, setup.valid, bh, bw,
                                  y0, x0)
        args = (setup.coef, payload, bins, lut, _light(dev), bh, bw, y0, x0)
        z_k, src_k, _ = prf.render_fused(*args)
        z_p, src_p, _ = prf.render_fused_plain(*args)
        assert int(torch.isfinite(z_k).sum()) > 100
        assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
        assert torch.equal(src_k.view(torch.int32), src_p.view(torch.int32))
