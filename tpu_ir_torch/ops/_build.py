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

Every library `build()` or `load()` brings up enters the process's build
ledger (`build_ledger()`): its source and library name, whether a
compiler ran or a built library was reused, the compiler's and the
load's seconds, and for a kernel library ptxas's report of each kernel
(registers, spills, stack and shared memory), parsed from nvcc's
`-Xptxas -v` output, which is kept beside the library so a reused one
reports it too. A build or load inside a profiled call
(obs/profiling.py) is that call's `dispatch.compile` span.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
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
# library file name -> its ledger entry, in the order they came up
_ledger: dict[str, dict] = {}
_ledger_lock = threading.Lock()


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills, stack and shared memory of each kernel in
    nvcc's `-Xptxas -v` output, one dict a kernel in the log's order (a
    template instance named `name<N>`)."""
    kernels = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r"\d([a-z_]+_kernel)(?:IL[bi](\d+)E)?",
                              m.group(1))
            kernels.append({"kernel": (
                short.group(1) + (f"<{short.group(2)}>" if short.group(2)
                                  else "")) if short else m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernels:
            kernels[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernels:
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[-1].update(registers=int(m.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    return kernels


def _note(lib: Path, **fields) -> dict:
    """Merge `fields` into the ledger entry of the library file `lib`."""
    with _ledger_lock:
        entry = _ledger.setdefault(lib.name, {"library": lib.name})
        entry.update(fields)
        return dict(entry)


def build_ledger() -> list[dict]:
    """The libraries this process built or loaded, in the order they came
    up: `source`, `library`, `compiler` (nvcc or g++), `built` (the
    compiler ran here) or not (a built library was reused), `compile_s`
    (0.0 when reused), `load_s` (the dlopen; None until loaded) and, for
    a kernel library, `ptxas` (ptxas_report of the compiler's log)."""
    with _ledger_lock:
        return [dict(e) for e in _ledger.values()]


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".log")


def _profiled_build(seconds: float) -> None:
    """Bill a build or load to the profiled call in flight, if any."""
    from ..obs import profiling

    profiling.note_build(seconds)


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
    the compiler's output (ptxas's resource report) of each one built;
    every name enters the build ledger, a reused library with the report
    kept beside it."""
    started, logs = [], {}
    try:
        for name in names:
            out = lib_path(name)
            src = f"tpu_ir_torch/csrc/{name}.cu"
            if out.exists():
                if out.name not in _ledger:    # built by another process
                    log = _log_path(out)
                    _note(out, source=src, compiler="nvcc", built=False,
                          compile_s=0.0, load_s=None,
                          ptxas=ptxas_report(log.read_text())
                          if log.exists() else None)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started.append((name, out, tmp, proc, time.perf_counter()))
        for name, out, tmp, proc, t0 in started:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            # the log goes into place first, and atomically like the
            # library: a process that finds the library finds a whole log
            log_path = _log_path(out)
            log_tmp = log_path.with_suffix(f".{os.getpid()}.tmp")
            log_tmp.write_text(log)
            os.replace(log_tmp, log_path)
            os.replace(tmp, out)
            logs[name] = log
            _note(out, source=f"tpu_ir_torch/csrc/{name}.cu",
                  compiler="nvcc", built=True, compile_s=seconds,
                  load_s=None, ptxas=ptxas_report(log))
    finally:
        for _, _, tmp, proc, _ in started:           # only after a failure
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
                t0 = time.perf_counter()
                build([name])
                t1 = time.perf_counter()
                lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
                t2 = time.perf_counter()
                _note(lib_path(name), load_s=t2 - t1)
                _profiled_build(t2 - t0)
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
    t0 = time.perf_counter()
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
        _note(out, source=_repo_relative(src), compiler="g++", built=True,
              compile_s=time.perf_counter() - t0, load_s=None, ptxas=None)
    finally:
        tmp.unlink(missing_ok=True)


def _repo_relative(src: Path) -> str:
    try:
        return str(Path(src).resolve().relative_to(_PKG.parent))
    except ValueError:
        return str(src)


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
        t0 = time.perf_counter()
        out = host_lib_path(src)
        if out.exists():
            _note(out, source=_repo_relative(src), compiler="g++",
                  built=False, compile_s=0.0, load_s=None, ptxas=None)
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
        seconds = time.perf_counter() - t0
        _note(out, load_s=seconds - _note(out)["compile_s"])
        _profiled_build(seconds)
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
