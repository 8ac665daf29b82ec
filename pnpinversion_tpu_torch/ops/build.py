"""Builds the port's kernels and loads them with ctypes: the CUDA kernels
with nvcc, the host's C++ data kernels (``csrc/data_ops.cpp``) with g++.

Each ``csrc/<name>.cu`` (``<name>.cpp``) is compiled on first use into one
shared library with a plain C interface, under ``build/torch_kernels/`` at
the root of the checkout (listed in .gitignore). The file name carries a hash
of the source, the headers of ``csrc/`` it may include and the flags, so an
edited source or header is rebuilt and a stale library is never loaded; the
finished file is moved into place with ``os.replace``, so processes that
build the same library at once never load half a file. Nothing here runs at
import time: the CPU tests import every module of the port on a machine
without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# no -march=native: build/ travels with the checkout to other hosts; no
# contraction into FMAs, so the bilinear resize rounds as the plain double
# arithmetic on every host
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def nvcc() -> str:
    """nvcc of the toolkit PyTorch finds ($CUDA_HOME, PATH, /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return path


def nvcc_command(src: Path, out: Path) -> list:
    """nvcc with the port's flags, ``csrc/`` on the include path."""
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compiles every named source that has no library yet, one nvcc process
    each, all started together. Returns seconds per built source; raises with
    nvcc's output when one fails. nvcc's output, with ptxas' registers and
    shared memory per kernel, is kept beside the library (``build_log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", Path(tmp)),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def host_library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_host(name: str) -> Path:
    """Compiles ``csrc/<name>.cpp`` with the host's g++ unless its library
    exists; raises with g++'s output when it fails or there is no g++."""
    out = host_library_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {name}.cpp needs a host C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {name}.cpp (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cpp``, built first if needed."""
    return ctypes.CDLL(str(build_host(name)))
