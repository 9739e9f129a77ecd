"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

into `build/repro_torch/` at the root of the checkout (listed in
.gitignore), at first use. The file name carries a hash of the source and
the flags, so an edited source never loads a stale library. `build_all`
starts one nvcc per source, all at once, and waits for every one. The
libraries are loaded with ctypes; nothing here includes PyTorch's
headers, which keeps a build to seconds.

Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> List[str]:
    """Names of every kernel source (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a private temporary file; returns
    (process, tmp path, final path, log file), or None when already
    built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(job) -> None:
    proc, tmp, out, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}) for {out.name}:\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)           # atomic: concurrent builders agree


def build_all(names=None) -> Dict[str, Path]:
    """Compile every named source (default: all), one nvcc each, all
    started together. Returns {name: library path}."""
    names = sources() if names is None else list(names)
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    errors = []
    for job in jobs:               # wait for all, even after a failure
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for `name`,
    or "" if the library was built by an earlier process."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
