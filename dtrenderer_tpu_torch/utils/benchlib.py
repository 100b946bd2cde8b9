"""Timing helper. Port of `dtrenderer_tpu/utils/benchlib.py`'s device_time.

The reference compiles one while_loop program and perturbs its arguments so
XLA cannot hoist the body; eager PyTorch runs every call, so a plain loop of
calls between two CUDA events is the device's time.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _device_of(args, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device_time: no tensor among the arguments; pass "
                     "device= to say where fn runs")


def device_time(fn, *args, device=None, iters: int = 20,
                warmup_iters: int = 2, repeats: int = 1) -> float:
    """Seconds per call of fn(*args): `iters` back-to-back calls between two
    CUDA events on the device's current stream (on the CPU: the host clock
    around the loop), after `warmup_iters` untimed calls. repeats > 1
    returns the median of that many such readings.

    fn runs on `device`, by default where the first tensor in args lies;
    without a tensor among the args, `device` is required. Host work
    between the calls counts when it outlasts the device's (the card then
    waits for the host)."""
    device = _device_of(args, device)
    cuda = device.type == "cuda"
    for _ in range(warmup_iters):
        fn(*args)
    samples = []
    for _ in range(max(1, repeats)):
        if cuda:
            torch.cuda.synchronize(device)
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                fn(*args)
            stop.record(stream)
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            samples.append((time.perf_counter() - t0) / iters)
    return float(np.median(samples))
