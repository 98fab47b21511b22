"""Build the native box-IoU kernel: g++ -O3 -shared -fPIC bbox.cpp -> libbbox.so.

`native/bbox.cpp` is the port's byte-equal copy of the JAX package's C++
IoU. It builds at first use (`utils/bbox.py`) into
`build/mmnas_tpu_torch/libbbox.so` at the root of the checkout, and again
whenever the source is newer than the library; or by hand:

    python -m mmnas_tpu_torch.native.build
"""

from __future__ import annotations

import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "bbox.cpp"
LIB = SRC.parents[2] / "build" / "mmnas_tpu_torch" / "libbbox.so"
# a process's threads build one at a time: a loader's worker threads reach
# the first use together, and would compile into, and rename, one file
_BUILD_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    with _BUILD_LOCK:
        if not force and LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
            return str(LIB)
        LIB.parent.mkdir(parents=True, exist_ok=True)
        # compile beside the library and rename: processes that build at once
        # never open a half-written file
        tmp = LIB.with_name(f"libbbox.{os.getpid()}.so")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, LIB)
        return str(LIB)


if __name__ == "__main__":
    print(build(force=True))
