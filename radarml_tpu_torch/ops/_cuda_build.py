"""Build and load the port's native libraries at first use.

Each `csrc/*.cu` file compiles with nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, which `load_library` opens
with ctypes; `drivers/native.py` builds its C++ scan source with g++
through the same `compile_once`. A library lands in
`radarml_tpu_torch/_build/` (listed in .gitignore) under a name keyed
on its source's hash and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time, and
nothing falls back: a missing compiler or a failed build raises.

`count_launch` is the one increment of the kernels' launch counters:
leader threads of the serving layers call one predictor at once, and a
bare `+= 1` on a shared counter can lose counts between threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, MutableMapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def count_launch(counts: MutableMapping, key: str) -> None:
    """Add one to counts[key] under a lock. A kernel wrapper calls it
    after a successful launch: `count_launch(globals(), "KERNEL_LAUNCHES")`
    for a module counter, `count_launch(LAUNCHES, name)` for a dict."""
    with _count_lock:
        counts[key] += 1


def find_nvcc() -> str:
    """nvcc from PATH, CUDA_HOME or /usr/local/cuda; raises if absent."""
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source at first use"
    )


def keyed_path(src: Path, flags: Sequence[str]) -> Path:
    """Where `src` builds to under `flags`, keyed on both."""
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def compile_once(src: Path, compiler: str, flags: Sequence[str]) -> Path:
    """Compile `src` into a shared library unless it already exists.

    The compiler writes to a temporary name that is renamed into place,
    so concurrent builds never load a half-written library.
    """
    out = keyed_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed for {src.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed on source and flags."""
    return keyed_path(CSRC / f"{name}.cu", NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` with nvcc unless its library exists."""
    return compile_once(CSRC / f"{name}.cu", find_nvcc(), NVCC_FLAGS)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and open `csrc/<name>.cu`'s library, once per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
