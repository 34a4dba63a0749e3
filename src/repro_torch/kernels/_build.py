"""Build and load the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
of the checkout (override with ``REPRO_TORCH_BUILD_DIR``), then loaded with
``ctypes``. A library is keyed by the hash of its source, so an edited source
rebuilds and a second process reuses the first one's output. Nothing here
runs at import time, and a build or load failure raises — callers never fall
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "build_dir", "find_nvcc", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIBS: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda and "
        "$PATH): the CUDA kernels of repro_torch are compiled at first use"
    )


def load_library(name: str, *, verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out = out_dir / f"lib{name}-{digest}.so"
    if not out.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{out.name}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
