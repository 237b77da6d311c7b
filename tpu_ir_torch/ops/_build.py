"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface and is compiled on first use
by `nvcc` into its own shared library, which `ctypes` loads. The libraries
go into `build/tpu_ir_torch/` beside the package (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import: the
CPU test suite imports every module on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_ir_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def lib_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu goes, named by content hash."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def kernel_sources() -> list[str]:
    """Names of every kernel source under csrc/ (without the .cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    out = lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            str(CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    lib = _libs[name] = ctypes.CDLL(str(out))
    return lib
