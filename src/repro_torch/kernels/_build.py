"""Build-and-load for the hand-written CUDA kernels.

Each kernel module keeps its CUDA C++ under ``csrc/`` with a plain C
interface. At first use ``load_library`` compiles the sources with ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``build/repro_torch/``
at the repo root and loads it with ``ctypes``. The file name carries a hash
of the sources and flags, so an edited source never loads a stale library;
the library is written to a temporary name and renamed, so concurrent
builders never see a half-written file. ``nvcc -Xptxas -v`` output
(registers, shared memory, spills) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was already built
    ptxas_log: str


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "kernels build on a machine with the CUDA toolkit"
        )
    return found


def load_library(name: str, sources: list[Path]) -> BuiltLibrary:
    """Compile ``sources`` into ``build/repro_torch/lib<name>-<hash>.so``
    unless that file exists, then load it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return BuiltLibrary(
        lib=ctypes.CDLL(str(so)),
        path=so,
        build_seconds=seconds,
        ptxas_log=log.read_text() if log.exists() else "",
    )
