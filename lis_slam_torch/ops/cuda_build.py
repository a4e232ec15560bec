"""Build and load the hand-written CUDA kernels under lis_slam_torch/csrc/.

Each `csrc/<name>.cu` is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into `lis_slam_torch/_build/`
(git-ignored), and loaded with ctypes. The library file name carries a hash
of the source and the flags, so an edited source rebuilds. Nothing here
runs at import: the CPU path never touches nvcc or ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str, flags: tuple[str, ...]) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


@functools.cache
def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per source + flags) and load it. The
    compiler's output (ptxas register/spill report included) is kept beside
    the library as `<lib>.log` (see build_log)."""
    flags = _BASE_FLAGS + tuple(extra_flags)
    src, lib = _lib_path(name, flags)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        lib.with_name(lib.name + ".log").write_text(log)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def build_log(name: str, extra_flags: tuple[str, ...] = ()) -> str:
    """The compiler output kept for csrc/<name>.cu (after `load`)."""
    _src, lib = _lib_path(name, _BASE_FLAGS + tuple(extra_flags))
    log = lib.with_name(lib.name + ".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
