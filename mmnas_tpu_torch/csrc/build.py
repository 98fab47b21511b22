"""Build the port's CUDA kernels with nvcc, at first use.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface, loaded with ctypes by its wrapper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -o build/mmnas_tpu_torch/lib<name>-<hash>.so

`--split-compile=0` runs the device compiler's optimization passes on as
many threads as the machine has: the attention sources instantiate dozens
of kernel templates, and on an H100 host it took the three sources' build
(all at once) from 142-154 s to 69 s, every kernel's registers, spills and
HMMA count unchanged.

The library lands in `build/mmnas_tpu_torch/` at the root of the checkout,
named by a hash of its sources and flags, so an edited source never loads a
stale build. A failed compile raises with nvcc's output. `load` builds and
opens a library once per process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "mmnas_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels build only with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless its library exists already.
    Returns (library path, ptxas report; empty when nothing was built)."""
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built at first use, opened with ctypes."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
