"""Build and load the Hopper kernels of ``paddle_tpu_torch/csrc``.

Every ``csrc/*.cu`` compiles at first use into its own shared library
with a plain C interface (no PyTorch headers, so a source builds in
seconds), one ``nvcc`` process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so

The libraries land in ``build/kernels/`` at the repository root, named by
a hash of the sources and flags, so a later process on the same machine
loads them without compiling. The wrappers bind them through ``ctypes``:
pointers and the stream travel as ``c_void_p`` and every entry point
returns ``cudaGetLastError()``. A failed build raises; there is no
fallback to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Built(NamedTuple):
    path: Path
    seconds: float     # compile time in this process (0.0 when cached)
    ptxas: str         # the compiler's -Xptxas -v report


_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILT: Dict[str, Built] = {}
_SMS: Dict[int, int] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper "
            "kernels are compiled from paddle_tpu_torch/csrc at first use")
    return nvcc


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Built]:
    """Compile every ``csrc/*.cu`` that has no library for its current
    content yet, all in parallel; returns {name: Built}. Raises
    RuntimeError with the compiler output when any source fails."""
    if _BUILT:
        return dict(_BUILT)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            _BUILT[src.stem] = Built(out, 0.0, log.read_text())
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        jobs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out, log, tmp, time.perf_counter())
    failed = []
    for name, (proc, out, log, tmp, t0) in jobs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{text}")
            continue
        os.replace(tmp, out)      # atomic: a reader never sees a torn .so
        log.write_text(text)
        _BUILT[name] = Built(out, secs, text)
    if failed:
        raise RuntimeError("Hopper kernel build failed:\n" + "\n".join(failed))
    return dict(_BUILT)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source first if this process has not yet)."""
    lib = _LIBS.get(name)
    if lib is None:
        built = build_all()
        if name not in built:
            raise RuntimeError(f"no kernel source csrc/{name}.cu")
        lib = ctypes.CDLL(str(built[name].path))
        _LIBS[name] = lib
    return lib


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached): the split-K
    policies size their grids by it."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error (launch refused,
    too much shared memory, ...): such a launch never ran, and no later
    synchronize would say so."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
