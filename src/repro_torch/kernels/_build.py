"""Build the port's CUDA kernels and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \
         csrc/<name>.cu

into a shared library with a plain C interface.  No PyTorch header is
included, so a source builds in seconds.  The library's file name
carries a hash of its source, the shared headers (`csrc/*.cuh`) and the
flags: an edited source or header builds anew,
an unchanged one is loaded as it is.  Nothing is built when this module
is imported; the first launch builds what it needs, and `build()`
builds several sources at once (one nvcc process each, all started
together).

`-Xptxas -v` makes ptxas report each kernel's registers and spilled
bytes; `ptxas_usage()` reads that report for the sources built by this
process.

Every C entry point returns `cudaGetLastError()` after its launch;
`Launcher` raises when that is not 0 and counts launches that succeed.
Under `torch.profiler` each call runs inside an `mz.launch` host op
(`repro_torch.spans.op`), so the profiler links the kernel to its launch.
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

import torch

from repro_torch.spans import op

_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# build/kernels/ at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_norm", "fused_mlp", "flash_attention", "paged_decode",
           "moe_mlp", "wkv6", "rglru_scan")

# loaded libraries by source name; guarded by _LOCK (launches may come
# from several threads, the first one of each source builds it)
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output (the ptxas report) of each source built by this process
_BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler; raises where the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, all in
    parallel; returns the seconds it took.  Raises with nvcc's output
    when a source does not compile."""
    t0 = time.perf_counter()
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            _BUILD_LOGS[name] = log.decode(errors="replace")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_usage(name: str) -> list[dict] | None:
    """Per kernel of `csrc/<name>.cu`, from ptxas's report: the (mangled)
    entry name, registers a thread and bytes of spill stores and loads.
    None when this process did not build the source (its library was
    already there)."""
    log = _BUILD_LOGS.get(name)
    if log is None:
        return None
    usage: dict[str, dict] = {}
    cur = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = usage.setdefault(m.group(1), {
                "kernel": m.group(1), "registers": None,
                "spill_stores": None, "spill_loads": None})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:          # also reported for non-inlined device functions
            props = usage.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props is not None:
            props["spill_stores"], props["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return list(usage.values())


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_library_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


class Launcher:
    """One C entry point of one library.  `launches` counts the calls
    that launched the kernel; nothing else changes it."""

    def __init__(self, lib_name: str, symbol: str, argtypes: list):
        self.lib_name = lib_name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _resolve(self):
        if self._fn is None:
            fn = getattr(library(self.lib_name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._resolve()
        with op("mz.launch"):
            err = fn(*args)
        if err != 0:
            msg = getattr(library(self.lib_name),
                          f"{self.lib_name}_error_string")(err)
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({msg.decode(errors='replace')})")
        self.launches += 1


VOID_P = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_longlong
FLOAT = ctypes.c_float

# element-type codes the C entry points switch on (csrc/dtypes.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the 16-bit types: the tensor-core routes, 16-byte rows of 8 values
HALF_TYPES = (torch.bfloat16, torch.float16)


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        f"(float32, bfloat16 or float16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must lie on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")


def tile_inputs(what: str, x: torch.Tensor, tensors) -> list[torch.Tensor]:
    """The tensors as the MLP tile reads them: each contiguous and, in a
    16-bit type, starting on a 16-byte boundary (the cluster tile reads
    them by TMA); a tensor that is neither is copied.  Raises unless every
    tensor shares x's dtype."""
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{what}: inputs must share x's dtype")
    return [t if t.is_contiguous() and (x.dtype not in HALF_TYPES or
                                        t.data_ptr() % 16 == 0)
            else t.clone(memory_format=torch.contiguous_format) for t in tensors]


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream
