"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``: no PyTorch headers,
so a build takes seconds. Libraries go to ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``) at first use, and are
rebuilt when their source is newer. All sources build in parallel, one
``nvcc`` each. A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(src: Path) -> bool:
    out = lib_path(src.stem)
    return not out.exists() or out.stat().st_mtime < src.stat().st_mtime


def build_all(force: bool = False) -> List[Path]:
    """Compile every stale ``csrc/*.cu`` (all at once); return the
    library paths. Raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if force or _stale(s)]
    procs = []
    for src in todo:
        tmp = BUILD_DIR / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(src.stem))   # atomic under races
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return [lib_path(s.stem) for s in sources()]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if it
    is missing or stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            if _stale(src):
                build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        return lib
