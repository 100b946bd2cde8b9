"""bench_torch, the port's benchmark, on the CPU: every cell through
`main(["--cpu", ...])` in-process at the reference's smoke sizes (one
readable JSON line, correct, n as SMOKE_COUNTS asks, no device metric from
a CPU run), the gate's two checks and its control, the NumPy reference
against the scalar oracle, the exit without a card, the trace arithmetic
on a synthetic Chrome trace (a CPU run has no device operation to read),
the traced window's warm-up and its checks of the vertex graph's counts,
and BENCHMARK.json against the cells."""

import contextlib
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from bench_torch import bounds, reference, run
from bench_torch.cells import CELLS, Cell, Workload
from dtrenderer_tpu_torch.models import primitives
from dtrenderer_tpu_torch.ops import pipeline, render_fused, vertex_graph
from dtrenderer_tpu_torch.utils import math3d as m3
from oracle_pipeline import MeshOracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = run.SMOKE_COUNTS.samples


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores; these small eager tensors
    gain nothing from torch's intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [c.name for c in CELLS])
def test_cell_on_the_cpu(cell, tmp_path, capsys):
    rc = run.main(["--cpu", "--cell", cell, "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert len(out) == 1
    line = json.loads(out[0])
    assert (line["cell"], line["metric"], line["unit"]) == (cell, "frame_ms",
                                                            "ms")
    assert line["vs_baseline"] is None
    extra = line["extra"]
    assert extra["correct"] is True, extra
    assert extra["n"] == N_SAMPLES and len(extra["samples_ms"]) == N_SAMPLES
    # frame_ms is the window's mean: a slow frame moves it
    assert line["value"] == pytest.approx(sum(extra["samples_ms"])
                                          / N_SAMPLES)
    assert extra["p10"] <= extra["median_ms"] <= extra["p90"]
    assert extra["max_ms"] == max(extra["samples_ms"])
    assert extra["audit"]["overflow"] == 0
    gate = extra["gate"]
    for check in ("twins", "reference"):
        assert gate[check]["depth_mismatch"] == 0
        assert gate[check]["u8_outliers"] == 0
        # the control fails both limits of both checks
        assert gate["control"][check]["depth_mismatch"] > 0
        assert gate["control"][check]["u8_outliers"] > 0
    assert gate["sampled_px"] == min(reference.LATTICE, extra["height"]) * \
        min(reference.LATTICE, extra["width"])
    assert gate["sampled_covered_px"] > 0
    assert gate["covered_px"] > 0
    if cell == "api_frame_1080p":
        assert gate["counters"]["pixels_shaded"] > 0
    assert extra["mpix_s"] > 0 and extra["mtris_s"] > 0
    # the plain twins ran: no launch was counted
    assert set(extra["launches_per_frame"].values()) == {0}
    assert (extra["card"], extra["device"]["platform"]) == ("cpu", "cpu")
    for device_metric in ("device_busy_share", "device_ms_per_frame",
                          "device_time_ms", "kernel_ms",
                          "peak_mem_frame_bytes"):
        assert extra[device_metric] is None
    if cell != "api_frame_1080p":
        assert extra["stage_frames"] == 1
        assert extra["vertex_pack_ms"] > 0 and extra["binning_ms"] > 0
    if cell == "config5_4k_1m_pallas":
        assert extra["deferred_shade_ms"] > 0
    # the CPU never graphs the vertex stage
    assert extra["vertex_graph_per_frame"] == {"eager": 0, "captures": 0,
                                               "replays": 0}
    assert os.path.getsize(tmp_path / cell / "trace.json") > 0


def _one_soup_line(tmp_path, capsys):
    rc = run.main(["--cpu", "--cell", "soup_200k_1080p", "--trace-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return rc, json.loads(out[0])


def test_a_cell_that_fails_its_gate_gets_no_timing(monkeypatch, tmp_path,
                                                   capsys):
    real = render_fused.render_fused_plain

    def deeper(*args, **kwargs):
        # the draw call's K1 merges into the framebuffer: its depth, one
        # deeper (in place, so that planes given as `out` hold it too)
        merged, overflow, shaded = real(*args, **kwargs)
        merged.depth.add_(1.0)
        return merged, overflow, shaded

    @contextlib.contextmanager
    def wrong_twins():
        with mock.patch.object(pipeline, "render_fused", deeper):
            yield

    monkeypatch.setattr(run, "plain_twins", wrong_twins)
    rc, line = _one_soup_line(tmp_path, capsys)
    assert rc == 1 and line["value"] is None
    extra = line["extra"]
    assert extra["correct"] is False and "samples_ms" not in extra
    assert extra["gate"]["problems"] == ["depth differs from the plain "
                                         "route"]


def test_a_fault_both_routes_share_fails_the_reference_check(
        monkeypatch, tmp_path, capsys):
    """Binning that drops every other triangle: the kernel and its plain
    twin draw the same wrong frame, the NumPy reference does not."""
    real = pipeline.bin_triangles

    def lossy(coef, bbox, valid, *args, **kwargs):
        keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
        return real(coef, bbox, valid & keep, *args, **kwargs)

    monkeypatch.setattr(pipeline, "bin_triangles", lossy)
    rc, line = _one_soup_line(tmp_path, capsys)
    assert rc == 1 and line["value"] is None
    gate = line["extra"]["gate"]
    assert gate["twins"]["depth_mismatch"] == 0
    assert gate["reference"]["depth_mismatch"] > 0
    assert "depth differs from the reference" in gate["problems"]


def test_a_blind_control_fails_the_gate(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(run, "CONTROL_BITS", {"depth": 23, "color": 23})
    rc, line = _one_soup_line(tmp_path, capsys)
    assert rc == 1 and line["value"] is None
    problems = line["extra"]["gate"]["problems"]
    assert len(problems) == 2
    assert all(p.startswith("the control passes a limit") for p in problems)


def test_truncate_keeps_the_top_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -5 + 2.0 ** -20, -3.0, 0.0,
                      float("inf")])
    got = run.truncate(x, 4)
    assert got.tolist() == [1.0, -3.0, 0.0, float("inf")]
    assert run.truncate(x, 5)[0].item() == 1.0 + 2.0 ** -5
    assert torch.equal(run.truncate(x, 23), x)


@pytest.mark.parametrize("shading,sampling,textured,ordered", [
    ("phong", "bilinear", True, False), ("gouraud", "nearest", False, False),
    ("flat", "nearest", True, False), ("none", "bilinear", True, False),
    ("gouraud", "bilinear", True, True)])
def test_reference_equals_the_scalar_oracle(shading, sampling, textured,
                                            ordered):
    """bench_torch.reference on every pixel of a small frame, bit for bit
    the scalar oracle of tests/oracle_pipeline.py: one winner per pixel, or
    (ordered) every fragment blended in submission order."""
    h, w = 24, 32
    mesh = primitives.uv_sphere(6, 8, device="cpu")
    mdl = m3.model_matrix((0.1, -0.1, -2.5), m3.rotate_y(0.7, device="cpu"),
                          1.2, device="cpu")
    proj = m3.perspective(np.pi / 3, w / h, 0.1, 100.0, device="cpu")
    tex = (primitives.checkerboard(8, 4, device="cpu").numpy() if textured
           else None)
    color = (0.9, 0.6, 0.3, 0.5 if ordered else 1.0)
    light = reference.Light(np.array([0.4, 0.6, 1.0], np.float32),
                            np.float32(0.15))
    draw = reference.Draw(mesh.verts.numpy(), mesh.uv.numpy(),
                          mesh.normals.numpy(), mesh.faces.numpy(),
                          mdl.numpy(), tex, color, shading, sampling)
    frame = reference.Frame.full(h, w)
    frame.clear((0.1, 0.1, 0.2, 1.0))
    tris = reference.mesh_batch([draw], proj.numpy(), light, w, h, True)
    shaded = (frame.draw_ordered if ordered else frame.draw_batch)(tris,
                                                                   light)
    orc = MeshOracle(mesh.verts.numpy(), mesh.uv.numpy(),
                     mesh.normals.numpy(), mesh.faces.numpy(), mdl.numpy(),
                     m3.mat4mul(proj, mdl).numpy(), mdl.numpy(),
                     np.ones((1, 1, 4), np.float32) if tex is None else tex,
                     light.direction, float(light.ambient), color, shading,
                     sampling, True, h, w)
    fb_color = np.broadcast_to(np.float32([0.1, 0.1, 0.2, 1.0]),
                               (h, w, 4)).copy()
    oc, od = (orc.render_sequential if ordered else orc.render)(
        fb_color, np.full((h, w), np.inf, np.float32))
    assert shaded == np.isfinite(od).sum() > 50
    np.testing.assert_array_equal(frame.depth.view(np.int32),
                                  od.reshape(-1).view(np.int32))
    np.testing.assert_array_equal(frame.color.view(np.int32),
                                  oc.reshape(-1, 4).view(np.int32))


def test_an_audit_overflow_fails_the_run(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(pipeline, "audit_scene", lambda *a, **k: (3, 9, None))
    rc, line = _one_soup_line(tmp_path, capsys)
    assert rc == 1 and line["value"] is None
    assert line["extra"]["correct"] is False
    assert "bin audit overflow" in line["extra"]["error"]


def test_without_a_card_and_without_cpu_it_exits(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--cell", CELLS[0].name])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_module_entry_point_exits_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "bench_torch"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "--cpu" in res.stderr


def test_device_profile_of_a_synthetic_trace(tmp_path):
    """Two frames of 10 us at ts 100 and 110 on host thread (1, 7); kernels
    overlapping, one running past the window; a CPU op on another thread
    that must not count; the frame thread's host events in two idle
    gaps."""
    span = dict(ph="X", cat="user_annotation", name=run.FRAME_SPAN, pid=1,
                tid=7)
    k1 = "render_fused_kernel(float const*, int)"
    events = [
        dict(span, ts=100.0, dur=10.0), dict(span, ts=110.0, dur=10.0),
        dict(ph="X", cat="kernel", name=k1, ts=102.0, dur=3.0),
        dict(ph="X", cat="kernel", name="elementwise", ts=104.0, dur=2.0),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=112.0,
             dur=1.0),
        dict(ph="X", cat="kernel", name=k1, ts=118.0, dur=4.0),
        dict(ph="X", cat="cpu_op", name="aten::add", ts=100.0, dur=20.0),
        dict(ph="i", cat="kernel", name="instant", ts=101.0),
        # the frame thread: a copy op and the launch inside it, then a span
        dict(ph="X", cat="cpu_op", name="aten::cat", ts=105.5, dur=5.0,
             pid=1, tid=7),
        dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=107.0,
             dur=2.0, pid=1, tid=7),
        dict(ph="X", cat="user_annotation", name="vertex_pack", ts=113.0,
             dur=3.0, pid=1, tid=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    prof = run.device_profile(str(path), 2)
    # busy: [102, 106] + [112, 113] + [118, 120] of [100, 120]
    assert prof["device_busy_share"] == pytest.approx(7 / 20)
    assert prof["device_ms_per_frame"] == pytest.approx(0.0035)
    assert prof["window_ms"] == pytest.approx(0.020)
    gaps = prof["idle_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.006, 0.005, 0.002])
    assert [(g["after"], g["before"]) for g in gaps] == [
        ("elementwise", "Memcpy HtoD"), ("Memcpy HtoD", k1),
        ("(first frame starts)", k1)]
    # [106, 112]: the launch 107-109 inside the op 105.5-110.5, then
    # Python; [113, 118]: the span, then Python; [100, 102]: Python only
    # (aten::add runs on another thread, the frame span names no gap)
    assert [[(h["name"], h["ms"]) for h in g["host"]] for g in gaps] == [
        [("aten::cat", pytest.approx(0.0025)),
         ("cudaMemcpyAsync", pytest.approx(0.002))],
        [("vertex_pack", pytest.approx(0.003))], []]
    assert [g["host_unnamed_ms"] for g in gaps] == pytest.approx(
        [0.0015, 0.002, 0.002])
    assert prof["kernel_ms_by_kernel"] == {"K1": pytest.approx(0.0035)}
    top = prof["top_device_ops"][0]
    assert (top["name"], top["calls_per_frame"]) == (k1, 1.0)
    assert top["ms_per_frame"] == pytest.approx(0.0035)
    path.write_text(json.dumps({"traceEvents": events[:2] + events[6:8]}))
    assert run.device_profile(str(path), 2) is None


def _fake_cell(calls, replays_graph=True):
    def frame():
        calls.append("frame")

    work = Workload(8, 8, 1, frame, None, None, None)
    return Cell("fake", {"K1": 1, "K2": 0, "K3": 0}, replays_graph,
                lambda device, smoke: work), work


def test_trace_cell_warms_up_before_the_traced_window(monkeypatch,
                                                      tmp_path):
    calls = []
    cell, work = _fake_cell(calls)

    def traced(w, device, n_frames, log_dir):
        assert w is work and n_frames == 2
        calls.append("traced")
        return {"K1": 0, "K2": 0, "K3": 0}, None

    monkeypatch.setattr(run, "traced", traced)
    counts = run.Counts(samples=1, warmup=3, trace=2, stages=1,
                        device_calls=0)
    extra = {}
    run.trace_cell(cell, torch.device("cpu"), counts, str(tmp_path), extra)
    assert calls == ["frame"] * 3 + ["traced"]
    assert (extra["trace_warmup_frames"], extra["trace_frames"]) == (3, 2)
    assert extra["device_ms_per_frame"] is None


@pytest.mark.parametrize("replays_graph,sightings,ok", [
    (True, (0, 0, 2), True), (True, (0, 0, 3), True),
    (True, (0, 1, 2), False),   # a capture in the window
    (True, (1, 0, 1), False),   # an eager pass in the window
    (True, (0, 0, 1), False),   # fewer replays than frames
    (False, (0, 0, 0), True), (False, (0, 0, 2), False)])
def test_the_traced_window_on_the_card_holds_steady_frames(
        monkeypatch, tmp_path, replays_graph, sightings, ok):
    """trace_cell's checks on the card (a stand-in device; sync and the
    traced frames faked): 2 traced frames that make `sightings` (eager,
    captures, replays) of the vertex graph."""
    cell, _ = _fake_cell([], replays_graph)

    def traced(w, device, n_frames, log_dir):
        for name, n in zip(("EAGER", "CAPTURES", "REPLAYS"), sightings):
            monkeypatch.setattr(vertex_graph, name,
                                getattr(vertex_graph, name) + n)
        return {"K1": 1, "K2": 0, "K3": 0}, None

    monkeypatch.setattr(run, "traced", traced)
    monkeypatch.setattr(run, "sync", lambda device: None)
    card = mock.Mock(type="cuda")
    counts = run.Counts(samples=1, warmup=1, trace=2, stages=1,
                        device_calls=0)
    extra = {}
    if ok:
        run.trace_cell(cell, card, counts, str(tmp_path), extra)
        assert extra["vertex_graph_per_frame"] == dict(zip(
            ("eager", "captures", "replays"), (n / 2 for n in sightings)))
    else:
        with pytest.raises(AssertionError, match="vertex graph"):
            run.trace_cell(cell, card, counts, str(tmp_path), extra)


def _benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_workloads_are_the_cells_in_order():
    assert [w["name"] for w in _benchmark()["workloads"]] == [
        c.name for c in CELLS]


def test_every_cell_a_metric_lists_is_a_workload():
    bench = _benchmark()
    names = {w["name"] for w in bench["workloads"]}
    for metric, spec in bench["metrics"].items():
        assert spec["cells"] and set(spec["cells"]) <= names, metric
    assert {w["config"] for w in bench["workloads"]} <= set(bench["configs"])


def test_every_workload_has_a_frame_ms_bound():
    for w in _benchmark()["workloads"]:
        rel = w["bounds"]["frame_ms"]["rel"]
        assert isinstance(rel, float) and rel > 0, w["name"]


def test_percentile_is_nearest_rank():
    ranked = [float(i) for i in range(1, 101)]
    assert run.percentile(ranked, 0.9) == 90.0  # ten samples beyond it
    assert run.percentile(ranked, 0.1) == 10.0
    assert run.percentile([5.0], 0.9) == 5.0


def test_bounds_from_several_invocations(tmp_path):
    def line(cell, value, correct=True, probe=1.0):
        return json.dumps({"cell": cell, "value": value,
                           "extra": {"correct": correct, "probe_ms": probe}})

    runs = [[line("a", 10.0), line("b", 4.0, probe=2.0)],
            [line("a", 12.0, probe=1.2), line("b", None, correct=False)],
            [line("a", 11.0), line("b", 4.1, probe=2.0)],
            # a cell run twice in one invocation is one longer window
            [line("c", 3.0), line("c", 5.0)], [line("c", 4.4)]]
    paths = []
    for i, lines in enumerate(runs):
        paths.append(tmp_path / f"run{i}.out")
        paths[-1].write_text("\n".join(lines) + "\n")
    got = bounds.bounds(paths)
    assert got["a"]["frame_ms"] == [10.0, 12.0, 11.0]
    assert got["a"]["bound_rel"] == 0.2
    assert got["a"]["per_probe"] == [10.0, 10.0, 11.0]
    assert got["a"]["per_probe_gap"] == 0.1
    assert got["b"]["frame_ms"] == [4.0, 4.1]
    assert got["b"]["bound_rel"] == 0.03  # 0.025 rounded up
    assert got["c"]["frame_ms"] == [4.0, 4.4]
    assert got["c"]["windows"] == 2 and got["c"]["bound_rel"] == 0.1
