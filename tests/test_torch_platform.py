"""The port's platform layer and utilities: scripted input, frame loop, hot
reload, PNG output (platform.py), PCG32 (utils/rng.py), checkpoints
(utils/checkpoint.py), the frame timer and trace (utils/trace.py), and the
demo and CLI tools run in-process on the CPU. Mirrors tests/test_platform.py
and holds the device streams, the checkpoint leaves and the PNG writer
against the JAX package, PIL and the native decoder."""

import importlib.util
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from dtrenderer_tpu import api as japi
from dtrenderer_tpu.utils import checkpoint as jckpt
from dtrenderer_tpu.utils import rng as jrng
from dtrenderer_tpu.utils.color import rgba as jrgba
from dtrenderer_tpu_torch import api as papi
from dtrenderer_tpu_torch import convert
from dtrenderer_tpu_torch import platform as plat
from dtrenderer_tpu_torch.assets import image as pimage
from dtrenderer_tpu_torch.assets import native as pnative
from dtrenderer_tpu_torch.debug import FrameCounters
from dtrenderer_tpu_torch.ops import fb as pfb
from dtrenderer_tpu_torch.tools import cli as pcli
from dtrenderer_tpu_torch.parallel import shard as pshard
from dtrenderer_tpu_torch.tools import demo as pdemo
from dtrenderer_tpu_torch.tools import dryrun as pdryrun
from dtrenderer_tpu_torch.utils import checkpoint as pckpt
from dtrenderer_tpu_torch.utils import rng as prng
from dtrenderer_tpu_torch.utils import trace as ptrace

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------- mirrors of tests/test_platform.py


def test_input_script_transitions():
    script = plat.InputScript({
        0: {"press": ["w"]},
        2: {"press": ["a"], "release": ["w"], "mouse_x": 7,
            "mouse_buttons": ["left"]},
    })
    f0 = script.next_frame()
    assert "w" in f0.keys_down and "w" in f0.keys_pressed
    f1 = script.next_frame()
    assert "w" in f1.keys_down and "w" not in f1.keys_pressed
    f2 = script.next_frame()
    assert "a" in f2.keys_down and "w" not in f2.keys_down
    assert abs(f2.time_now_s - 2 / 60) < 1e-9
    assert f2.mouse_x == 7 and f2.mouse_buttons == frozenset({"left"})


def test_run_app_loop():
    frames_seen = []

    def update(state, inp):
        return state + (1 if "w" in inp.keys_down else 0)

    script = plat.InputScript({0: {"press": ["w"]}, 3: {"release": ["w"]}})
    state, n, reloads = plat.run_app(
        update, 0, 6, script, on_frame=lambda i, s: frames_seen.append(i)
    )
    assert state == 3  # frames 0,1,2 had w down
    assert n == 6 and reloads == 0
    assert frames_seen == list(range(6))


def test_hot_reload_preserves_state(tmp_path):
    """A scene module that draws through the port's api; edit it mid-run:
    the loop picks up the new code while the RenderState survives. The
    module imports the port only."""
    source = (
        "from dtrenderer_tpu_torch import api\n"
        "from dtrenderer_tpu_torch.utils.color import rgba\n"
        "def update(state, inp):\n"
        "    x = 2 + 6 * int(round(inp.time_now_s * 60))\n"
        "    return api.render_rectangle(state, (x, 2), (x + 4, 6), %s)\n")
    mod_path = tmp_path / "hot_scene_torch.py"
    mod_path.write_text(source % "rgba(1, 0, 0, 1)")
    spec = importlib.util.spec_from_file_location("hot_scene_torch", mod_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules["hot_scene_torch"] = module
    jax_modules = {m for m in sys.modules if m.startswith("dtrenderer_tpu.")}
    reloader = plat.HotReloader(module)

    def edit_after_frame(i, state):
        if i == 2:
            mod_path.write_text(source % "rgba(0, 1, 0, 1)")
            os.utime(mod_path, (time.time() + 2, time.time() + 2))

    state0 = papi.clear(papi.new_state(48, 8, device=CPU))
    try:
        state, n, reloads = plat.run_app(
            module.update, state0, 6, reloader=reloader,
            on_frame=edit_after_frame)
    finally:
        del sys.modules["hot_scene_torch"]
    assert (n, reloads, reloader.reload_count) == (6, 1, 1)
    c = state.fb.color
    # frames 0..2 drew red squares, the reloaded code green ones; all six
    # survive in the one state
    for i in range(6):
        want = [1.0, 0.0, 0.0, 1.0] if i < 3 else [0.0, 1.0, 0.0, 1.0]
        assert c[3, 3 + 6 * i].tolist() == want, i
    assert {m for m in sys.modules
            if m.startswith("dtrenderer_tpu.")} == jax_modules


def test_present_png(tmp_path):
    """Round trip through PIL and through the port's native decoder, of a
    Framebuffer and of a RenderState."""
    rng = np.random.default_rng(3)
    color = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (21, 37, 3)), np.ones((21, 37, 1))],
        -1).astype(np.float32))
    fb = pfb.Framebuffer(color, torch.zeros(21, 37))
    want = pfb.pack(fb).numpy()
    p = str(tmp_path / "out.png")
    plat.present_png(fb, p)
    img = np.asarray(Image.open(p))
    assert img.shape == (21, 37, 4) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(pnative.decode_image_file(p), want)
    np.testing.assert_array_equal(
        pimage.load_bitmap(p, premultiply_linear=False, device=CPU), want)
    with open(p, "rb") as f:
        tex = pimage.decode_bytes(f.read(), device=CPU)
    assert torch.equal(tex, pimage.load_bitmap(p, device=CPU))
    assert tex.dtype == torch.float32 and tex.shape == (21, 37, 4)

    red = papi.clear(papi.new_state(16, 16, device=CPU), (1, 0, 0, 1))
    plat.present_png(red, p)
    img = np.asarray(Image.open(p))
    assert img.shape == (16, 16, 4)
    assert img[0, 0, 0] == 255 and img[0, 0, 1] == 0
    with pytest.raises(ValueError, match="H, W, 4"):
        plat.write_png(p, np.zeros((4, 4, 3), np.uint8))


def test_pcg32_reference_stream():
    r = prng.Pcg32(seed=42)
    seq = [r.next_u32() for _ in range(4)]
    r2 = prng.Pcg32(seed=42)
    assert seq == [r2.next_u32() for _ in range(4)]
    r3 = prng.Pcg32(seed=43)
    assert seq != [r3.next_u32() for _ in range(4)]
    j = jrng.Pcg32(seed=42)
    assert seq == [j.next_u32() for _ in range(4)]
    f = prng.Pcg32(seed=7)
    vals = [f.next_f32() for _ in range(100)]
    assert all(0.0 <= v < 1.0 for v in vals)
    assert 0.2 < float(np.mean(vals)) < 0.8
    ints = [prng.Pcg32(seed=1).range_i32(5, 10) for _ in range(10)]
    assert all(5 <= v < 10 for v in ints)


@pytest.mark.parametrize("seed", [42, 0x853C49E6748FEA9B, 2**63 + 17, 0],
                         ids=["42", "default", "top_bit", "zero"])
def test_pcg32_device_stream_matches_host_and_jax(seed):
    """Counter-based PCG32 == sequential host PCG32 == the JAX stream."""
    n = 1000
    g = prng.Pcg32(seed)
    host = np.asarray([g.next_u32() for _ in range(n)], np.uint32)
    dev = prng.pcg32_stream(seed, n, device=CPU)
    assert dev.dtype == torch.int64 and int(dev.min()) >= 0
    np.testing.assert_array_equal(dev.numpy().astype(np.uint32), host)
    ref = np.asarray(jax.jit(lambda: jrng.pcg32_stream(seed, 64))())
    np.testing.assert_array_equal(dev.numpy()[:64].astype(np.uint32), ref)
    g = prng.Pcg32(seed)
    hf = np.asarray([g.next_f32() for _ in range(16)], np.float32)
    pf = prng.pcg32_f32_stream(seed, 16, device=CPU)
    assert pf.dtype == torch.float32
    np.testing.assert_array_equal(pf.numpy(), hf)
    np.testing.assert_array_equal(
        pf.numpy(), np.asarray(jrng.pcg32_f32_stream(seed, 16)))


def test_pcg32_stream_with_another_increment():
    g = prng.Pcg32(9, inc=2**63 + 12345)
    host = [g.next_u32() for _ in range(50)]
    assert prng.pcg32_stream(9, 50, inc=2**63 + 12345,
                             device=CPU).tolist() == host


def test_transition_counts_and_fps_pacing():
    script = plat.InputScript({0: {"press": ["w"], "release": ["s"]}})
    f0 = script.next_frame()
    assert f0.transition_counts == {"w": 1, "s": 1}
    f1 = script.next_frame()
    assert f1.transition_counts == {}

    t0 = time.perf_counter()
    plat.run_app(lambda s, i: s, 0, 3, target_fps=100)  # 3 frames @ >=10ms
    assert time.perf_counter() - t0 >= 0.025


# --------------------------------------------------- checkpoint, timers


def _drawn_state():
    st = papi.clear(papi.new_state(32, 16, device=CPU), (0.1, 0.2, 0.3, 1))
    return papi.render_triangle(st, (2, 2, 0.4), (30, 3, 0.4), (4, 14, 0.4))


def test_checkpoint_round_trip(tmp_path):
    tree = {"state": _drawn_state(),
            "counters": FrameCounters.zero(CPU)._replace(
                tris_valid=torch.tensor(5, dtype=torch.int32)),
            "misc": [np.arange(4, dtype=np.int16), 3, 2.5, (None, True)]}
    p = str(tmp_path / "ck.npz")
    pckpt.save_pytree(p, tree)
    like = {"state": papi.new_state(32, 16, device=CPU),
            "counters": FrameCounters.zero(CPU),
            "misc": [np.zeros(4, np.int16), 0, 0.0, (None, False)]}
    got = pckpt.load_pytree(p, like)
    assert isinstance(got["state"], papi.RenderState)
    assert torch.equal(got["state"].fb.color, tree["state"].fb.color)
    assert torch.equal(got["state"].fb.depth, tree["state"].fb.depth)
    assert got["state"].fb.depth.dtype == torch.float32
    assert int(got["counters"].tris_valid) == 5
    assert got["counters"].tris_valid.dtype == torch.int32
    np.testing.assert_array_equal(got["misc"][0], np.arange(4))
    assert got["misc"][0].dtype == np.int16
    assert got["misc"][1:] == [3, 2.5, (None, True)]
    assert list(got) == list(tree)


def test_checkpoint_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck.npz")
    st = _drawn_state()
    pckpt.save_pytree(p, {"a": st, "b": 1})
    with pytest.raises(ValueError, match="structure mismatch"):
        pckpt.load_pytree(p, {"a": st})
    with pytest.raises(ValueError, match="structure mismatch"):
        pckpt.load_pytree(p, {"a": st.fb, "b": 1})
    with pytest.raises(ValueError, match="structure mismatch"):
        pckpt.load_pytree(p, [st, 1])
    assert torch.equal(pckpt.load_pytree(p, {"b": 0, "a": st})["a"].fb.depth,
                       st.fb.depth)


def test_checkpoint_leaves_equal_the_jax_packages(tmp_path):
    """A RenderState drawn by the JAX package, saved by its save_pytree, and
    the same state carried into the port (convert.render_state) and saved by
    the port's: the same leaves in the same order; and the port restores
    its file into the state the JAX package drew."""
    jst = japi.clear(japi.new_state(32, 16), jrgba(0.1, 0.2, 0.3, 1))
    jst = jax.jit(lambda s: japi.render_rectangle(
        s, (3, 2), (20, 9), jrgba(1, 0.5, 0, 0.5)))(jst)
    jtree = {"state": jst, "frame": jnp.int32(7)}
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_pytree(pj, jtree)
    ptree = {"state": convert.render_state(jst, CPU),
             "frame": torch.tensor(7, dtype=torch.int32)}
    pckpt.save_pytree(pp, ptree)
    with np.load(pj) as a, np.load(pp) as b:
        leaves = sorted(k for k in a.files if k.startswith("leaf_"))
        assert leaves == sorted(k for k in b.files if k.startswith("leaf_"))
        assert len(leaves) == 3
        for k in leaves:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    like = {"state": papi.new_state(32, 16, device=CPU),
            "frame": torch.zeros((), dtype=torch.int32)}
    got = pckpt.load_pytree(pp, like)
    np.testing.assert_array_equal(got["state"].fb.color.numpy(),
                                  np.asarray(jst.fb.color))
    np.testing.assert_array_equal(got["state"].fb.depth.numpy(),
                                  np.asarray(jst.fb.depth))
    assert int(got["frame"]) == 7


def test_frame_timer_and_trace(tmp_path):
    timer = ptrace.FrameTimer(window=3)
    assert timer.mean_ms == 0.0 and timer.fps == 0.0
    for _ in range(5):
        time.sleep(0.002)
        assert timer.tick() >= 2.0
    assert len(timer.samples) == 3
    assert timer.mean_ms >= 2.0 and 0 < timer.fps <= 500.0

    log_dir = str(tmp_path / "trace")
    with ptrace.trace(log_dir) as prof:
        papi.render_circle(_drawn_state(), (8, 8), 4, (1, 1, 1, 1))
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 100
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


# ----------------------------------------------- the tools, in-process


def _png_size(path):
    img = pnative.decode_image_file(path)
    assert img.dtype == np.uint8 and img[..., 3].min() == 255
    return img.shape, img


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_demo_main_on_cpu(tmp_path, monkeypatch, capsys, backend):
    out = str(tmp_path / "demo.png")
    monkeypatch.setattr(sys, "argv", [
        "demo", "--cpu", "--w", "64", "--h", "48", "--frames", "2",
        "--backend", backend, "--out", out])
    pdemo.main()
    shape, img = _png_size(out)
    assert shape == (48, 64, 4)
    assert len(np.unique(img[..., :3].reshape(-1, 3), axis=0)) > 20
    printed = capsys.readouterr().out
    assert "device: cpu" in printed and "frame 1:" in printed


@pytest.mark.parametrize("scene,extra", [
    ("demo", []), ("1", ["--backend", "ref"]), ("2", ["--backend", "pallas"]),
    ("5", ["--tris", "500", "--save-npy"]),
    (os.path.join(REPO, "data", "head.obj"), ["--frames", "2"]),
], ids=["demo", "config1_ref", "config2_pallas", "config5_npy", "obj"])
def test_cli_main_on_cpu(tmp_path, monkeypatch, scene, extra):
    out = str(tmp_path / "frame.png")
    monkeypatch.setattr(sys, "argv", [
        "cli", "--cpu", "--scene", scene, "--w", "64", "--h", "48", "--out",
        out, *extra])
    pcli.main()
    shape, img = _png_size(out)
    assert shape == (48, 64, 4)
    # config 1 is one flat triangle over the clear colour: two colours
    assert len(np.unique(img[..., :3].reshape(-1, 3), axis=0)) >= 2
    if "--save-npy" in extra:
        raw = np.load(out + ".npy")
        assert raw.shape == (48, 64, 4) and raw.dtype == np.float32


def test_tools_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    """Without a card and without --cpu the tools exit with an error and
    write nothing (with --rows/--cols too: a mesh never falls back to the
    CPU on its own); with --cpu, --rows/--cols above 1 render the unbanded
    frame bit for bit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.png"
    scene1 = ["--scene", "1", "--w", "32", "--h", "24"]
    for main, argv in ((pdemo.main, ["--w", "32", "--h", "24"]),
                       (pcli.main, scene1),
                       (pcli.main, scene1 + ["--rows", "2"])):
        with pytest.raises(SystemExit, match="--cpu"):
            main(argv + ["--out", str(out)])
        assert not out.exists()
    with pytest.raises(SystemExit, match="--cpu"):
        pdryrun.main(["--devices", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pshard.make_mesh(rows=2)
    whole = tmp_path / "whole.png"
    pcli.main(["--cpu", *scene1, "--save-npy", "--out", str(whole)])
    for flag in ("--rows", "--cols"):
        band = tmp_path / f"band{flag}.png"
        pcli.main(["--cpu", *scene1, flag, "2", "--save-npy", "--out",
                   str(band)])
        assert np.load(f"{band}.npy").tobytes() == np.load(
            f"{whole}.npy").tobytes()
        assert band.read_bytes() == whole.read_bytes()


@pytest.mark.parametrize("scene,extra", [
    ("4", []), ("4", ["--backend", "pallas"]), ("3", ["--frames", "2"]),
    (os.path.join(REPO, "data", "head.obj"), []),
], ids=["config4_fused", "config4_pallas", "config3_2frames", "obj"])
def test_cli_rows_cols_on_cpu(tmp_path, scene, extra):
    """--rows 4 --cols 2 (render_frames_sharded over a 1 x 4 x 2 mesh of
    cpu cells, the scenes' band arguments) gives the raw f32 frame of the
    unbanded CLI render, bit for bit. 60 = 4 x 15 rows: ragged bands."""
    base = ["--cpu", "--scene", scene, "--w", "96", "--h", "60", "--save-npy",
            *extra]
    whole, band = str(tmp_path / "whole.png"), str(tmp_path / "band.png")
    pcli.main(base + ["--out", whole])
    pcli.main(base + ["--rows", "4", "--cols", "2", "--out", band])
    a, b = np.load(whole + ".npy"), np.load(band + ".npy")
    assert a.shape == (60, 96, 4) and np.isfinite(a).all()
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 2
    assert a.tobytes() == b.tobytes()
    assert _png_size(band)[0] == (60, 96, 4)


def test_cli_demo_scene_does_not_split(tmp_path):
    with pytest.raises(SystemExit, match="demo scene"):
        pcli.main(["--cpu", "--rows", "2", "--out", str(tmp_path / "x.png")])


@pytest.mark.parametrize("cells", [8, 3])
def test_dryrun_on_cpu_cells(capsys, cells):
    """tools.dryrun in-process over `cells` cpu cells: every scene prints
    its ok line (an odd count has no frames x rows and no rows x cols
    mesh), and each is bit-equal inside (it raises otherwise)."""
    pdryrun.main(["--devices", str(cells), "--cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip ok")]
    assert len(lines) == (6 if cells % 2 == 0 else 5)
    for word in ("per-band binning", "shared cross-band", "DISTRIBUTED",
                 "ordered translucent"):
        assert sum(word in ln for ln in lines) == 1, word
    assert f"over {cells} bands of 24 rows" in lines[1]
