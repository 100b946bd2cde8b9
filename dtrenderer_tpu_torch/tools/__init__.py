"""Command-line tools of the port: `python -m dtrenderer_tpu_torch.tools.demo`,
`... .tools.cli`, `... .tools.bake_fonts`."""

from __future__ import annotations

import torch


def pick_device(cpu: bool) -> torch.device:
    """The device a tool renders on: the first card, or the CPU when the
    caller asks for it. Without a card and without that request the tool
    exits with an error and renders nothing."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); pass --cpu to render on the CPU")
    return torch.device("cuda:0")
