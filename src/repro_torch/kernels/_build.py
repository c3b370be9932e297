"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``: no PyTorch headers,
so a build takes seconds. Libraries go to ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``) at first use, and are
rebuilt when their source is newer. All sources build in parallel, one
``nvcc`` each, with ``-Xptxas -v``: each library's compiler report
(registers, shared memory, spills a kernel) is kept beside it as
``lib<name>.log``. A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def ptxas_summary(log: str) -> List[str]:
    """One line a kernel of a ``-Xptxas -v`` report: its name with the
    template argument (``flash_wgmma_k<64>``, ``output_k<bf16>``), its
    registers and its spill stores (ptxas gives the spills first)."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            found = re.search(r"\d+([a-z][a-z_]*_k)(?:I(?:Li(\d+)|(13__nv_"
                              r"bfloat16)|(f))E)?", line)
            if found:
                arg = found.group(2) or ("bf16" if found.group(3) else
                                         "f32" if found.group(4) else "")
                kernel = found.group(1) + (f"<{arg}>" if arg else "")
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif kernel and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{kernel}: {regs}, {spill}")
            kernel = None
    return out


def ptxas_report(name: str) -> List[str]:
    """``ptxas_summary`` of the last build of ``csrc/<name>.cu``."""
    return ptxas_summary(log_path(name).read_text())


def sass_count(name: str, opcode: str) -> int:
    """How many SASS instructions of ``csrc/<name>.cu``'s library start
    with ``opcode`` (``cuobjdump -sass``; e.g. HGMMA for wgmma)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    count = 0
    for line in sass.splitlines():
        words = line.split("*/", 1)[-1].split()       # after the address
        if words and words[0].startswith("@"):        # a predicate
            words = words[1:]
        count += bool(words) and words[0].startswith(opcode)
    return count


def _stale(src: Path) -> bool:
    out = lib_path(src.stem)
    return not out.exists() or out.stat().st_mtime < src.stat().st_mtime


def _nvcc_all(jobs: Dict[str, tuple]) -> Dict[str, str]:
    """Run one ``nvcc`` a job, all at once: {name: (source, library)} ->
    {name: compiler report}. Each library is written under a temporary
    name and renamed when done (atomic under races). Raises with the
    compiler's output on a failure."""
    procs = {}
    for name, (src, out) in jobs.items():
        tmp = out.with_name(f".{out.name}.{os.getpid()}")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failures = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def build_all(force: bool = False) -> List[Path]:
    """Compile every stale ``csrc/*.cu`` (all at once); return the
    library paths. Raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s.stem: (s, lib_path(s.stem)) for s in sources()
            if force or _stale(s)}
    for name, log in _nvcc_all(todo).items():
        log_path(name).write_text(log)
    return [lib_path(s.stem) for s in sources()]


def build_texts(texts: Dict[str, str], subdir: str) -> Dict[str, tuple]:
    """Compile each {name: CUDA source text} (all at once, the same flags)
    into ``BUILD_DIR/subdir``; {name: (library path, compiler report)}."""
    out = BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        jobs[name] = (out / f"{name}.cu", out / f"lib{name}.so")
    logs = _nvcc_all(jobs)
    return {name: (jobs[name][1], logs[name]) for name in texts}


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
