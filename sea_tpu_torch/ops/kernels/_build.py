"""Build the port's CUDA sources with nvcc at first use and load them.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
bound with `ctypes` (no PyTorch headers, so a build takes seconds). The
libraries go to `sea_tpu_torch/_build/`, which git ignores; a library's file
name carries a hash of its source, of the shared headers (`csrc/*.cuh`) and
of the flags, so an edited source or header is rebuilt and an unchanged one
is reused. `build_all` starts one nvcc per source, all
at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Hopper only (wgmma/setmaxnreg need the `a` target); no --use_fast_math:
# the kernels pin their own rounding where the semantics depend on it.
# `-Xptxas -v` prints each kernel's registers and spills into the build log,
# which chip_smoke.py reports; it does not change the code generated.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every CUDA source in `csrc/` (without the suffix)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    """The library's path: its name carries a hash of the source, of every
    header in `csrc/` (any of them may be included) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing library among `names` (default: all sources),
    one nvcc process each, all started together. Returns {name: compiler
    log} for the libraries built in this call; raises if any build fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
