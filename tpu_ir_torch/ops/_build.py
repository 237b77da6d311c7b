"""Build and load the port's native libraries: its hand-written CUDA
kernels, and the host-side C++ analyzer.

Each `csrc/*.cu` file has a plain C interface and is compiled on first use
by `nvcc` into its own shared library, which `ctypes` loads; `csrc/*.cuh`
holds code that several of them include. A host C++ source (the native
analyzer, `native/analyzer.cpp`) is compiled by `g++` the same way
(`load_host`). The libraries go into `build/tpu_ir_torch/` beside the
package (listed in .gitignore), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. Each
is compiled into a per-process temporary file and renamed into place, so
processes that build at once never load a half-written library. Nothing
here runs at import: the CPU test suite imports every module on a machine
without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_ir_torch"

# -Xptxas -v only reports each kernel's registers, spills and shared memory
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's flags for the same analyzer source
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_load_lock = threading.Lock()


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
    """Where the library of csrc/<name>.cu goes, named by a hash of the
    source, the shared headers (csrc/*.cuh) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def kernel_sources() -> list[str]:
    """Names of every kernel source under csrc/ (without the .cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str]) -> dict[str, str]:
    """Compile the libraries of `names` that are not built yet: one nvcc
    per source, all started together, then each awaited in turn. Returns
    the compiler's output (ptxas's resource report) of each one built."""
    started, logs = [], {}
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started.append((name, out, tmp, proc))
        for name, out, tmp, proc in started:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            logs[name] = log
    finally:
        for _, _, tmp, proc in started:              # only after a failure
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use (under a
    lock: concurrent first callers of one process share one build)."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu with its argument
    types, set once. Every entry point returns an int CUDA error code."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def host_lib_path(src: Path) -> Path:
    """Where the g++ library of the C++ source `src` goes, named by a
    hash of the source and the flags."""
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(src).stem}-{digest[:16]}.so"


def _compile_host(src: Path, out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: it is needed to build "
                           f"{src}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded g++ library of the C++ source `src`, built on first use
    under the load lock (a cached library another host's toolchain built,
    which does not load here, is built again). A missing compiler, a
    failed compile or a failed dlopen raises RuntimeError with the
    compiler's output: there is no fallback."""
    key = str(src)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        out = host_lib_path(src)
        if out.exists():
            try:
                lib = ctypes.CDLL(str(out))
            except OSError:
                out.unlink(missing_ok=True)
        if lib is None:
            _compile_host(src, out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                raise RuntimeError(f"cannot load {out} (built from {src}): "
                                   f"{e}") from e
        _libs[key] = lib
        return lib


class LaunchCounter:
    """A kernel's launch count, incremented by its wrapper where it
    launches the kernel; a lock keeps concurrent callers' launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
