"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain C interface; device code
the kernels share lives in `csrc/*.cuh` headers. A kernel is compiled with
one nvcc call into a shared library at first use and loaded with ctypes.
Builds land in `dtrenderer_tpu_torch/_build/` (listed in .gitignore), keyed
by a hash of the source, every header and the flags, so an edit of either
rebuilds and an unchanged tree loads the cached library. Nothing is built
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# Route (b) of the Hopper build: nvcc straight to a .so. --fmad=false keeps
# the FORMULAS.md op order (no a*b + c contracted into an FMA); no fast math,
# so divides and sqrt stay IEEE. -Xptxas -v records registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildInfo:
    """What the last build of a kernel library did (for the smoke report)."""

    def __init__(self, path: str, seconds: float, cached: bool, log: str):
        self.path = path
        self.seconds = seconds
        self.cached = cached
        self.log = log


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",  # the CUDA toolkit's default location
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are compiled from csrc/ at first use")


def source_digest(source_name: str, csrc_dir: str = CSRC_DIR) -> str:
    """Hash of csrc/<source_name>, every csrc/*.cuh (any of them may be
    included) and the flags: the key of the cached build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(csrc_dir) if n.endswith(".cuh"))
    for name in (source_name, *headers):
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def build(source_name: str, csrc_dir: str = CSRC_DIR) -> BuildInfo:
    """Compile csrc/<source_name> (if its cached build is missing) and
    return where the shared library is. `csrc_dir` names another tree's
    csrc/ (to time two versions of a kernel in one process)."""
    src = os.path.join(csrc_dir, source_name)
    stem = os.path.splitext(source_name)[0]
    digest = source_digest(source_name, csrc_dir)[:16]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildInfo(out, 0.0, True, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source_name} (rc {res.returncode}):\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a half-written .so is never loaded
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    log = res.stdout + res.stderr
    with open(log_path, "w") as f:
        f.write(log)
    return BuildInfo(out, time.perf_counter() - t0, False, log)


def load(source_name: str,
         csrc_dir: str = CSRC_DIR) -> tuple[ctypes.CDLL, BuildInfo]:
    info = build(source_name, csrc_dir)
    return ctypes.CDLL(info.path), info
