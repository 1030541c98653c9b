"""Compile the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` launcher and becomes
``build/repro_torch/<name>-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists), keyed by a hash of the source, every header
under ``csrc/`` (``*.cuh``, ``*.h``) and the flags, so an edited source or
header is rebuilt and an unchanged one is not.  All
sources asked for are compiled in parallel, one ``nvcc`` each.

Nothing here runs at import: the tests import every module on machines with
no ``nvcc``, and only a CUDA tensor reaching a kernel wrapper builds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """One compiled source: where it is, what it cost, what ptxas said."""

    name: str
    path: Path
    seconds: float    # nvcc wall time; 0.0 when an earlier build was reused
    ptxas: str        # ``-Xptxas -v`` lines: registers, shared memory, spills


def sources() -> Sequence[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")])
    for path in (CSRC / f"{name}.cu", *headers):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> str:
    return "\n".join(ln for ln in log.splitlines() if "ptxas info" in ln)


def build(names: Optional[Sequence[str]] = None) -> Dict[str, BuildResult]:
    """Build ``names`` (default: every source), one ``nvcc`` each, together.

    A library already built from the same source is reused.  A failed
    compile raises with the compiler's output.
    """
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.is_file():
            text = log.read_text() if log.is_file() else ""
            results[name] = BuildResult(name, target, 0.0, _ptxas_lines(text))
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, log, time.perf_counter())
    for name, (proc, tmp, target, log, t0) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        log.write_text(out)
        os.replace(tmp, target)        # atomic: a concurrent loader sees
        results[name] = BuildResult(   # either no library or a whole one
            name, target, seconds, _ptxas_lines(out))
    return results


def refuse_dtensor(**tensors) -> None:
    """Raise ``TypeError`` for a DTensor on the card: a launcher reads a
    local tensor's ``data_ptr()``, and a DTensor's is not the shard.  On
    the card the model runs on local tensors (a mesh of one device places
    nothing); a CPU DTensor takes the plain version and passes here."""
    from torch.distributed.tensor import DTensor
    for name, x in tensors.items():
        if isinstance(x, DTensor) and x.device.type == "cuda":
            raise TypeError(
                f"{name}: the CUDA kernel takes local tensors, got a DTensor "
                f"laid out as {tuple(x.placements)} on {x.device_mesh}")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``name``, building it first if needed."""
    return ctypes.CDLL(str(build([name])[name].path))
