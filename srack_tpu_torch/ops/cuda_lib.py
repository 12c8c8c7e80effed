"""Building and launching the port's CUDA sources.

:func:`build` compiles a source of ``csrc/`` (or a generated one) with nvcc
at first use into ``build/srack_tpu_torch/<hash>/``; :class:`CudaLib` is a
source with a plain C interface, loaded with ``ctypes``, launched on the
caller's stream, and counted.  Every kernel wrapper of the port launches
through :meth:`CudaLib.launch`.

The row-scan (K4), row-gather (K5, K6), Sample-player (K7), Freeverb
(K8), ring-alignment (K9) and Noise-lane kernels are sources of
``csrc/``; the fused kernels (K1, K2) and the serial-stage
kernel (K3) are generated per plan (``ops/fused.py``).  Every entry point
returns ``cudaGetLastError()`` after its launches; in the host build (g++,
for the CPU tests) the same entry takes no stream and runs the per-row or
per-voice body in a loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "srack_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# nvcc builds run and libraries loaded by this process (what
# ``utils.debug.recompile_guard`` watches)
EVENTS = {"nvcc": 0, "load": 0}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and Path(cuda_home, "bin", "nvcc").exists():
        return str(Path(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the fused "
        "kernel is built from source at first use")


def build(source: str, compiler=None, flags=NVCC_FLAGS,
          root: Path = BUILD_ROOT, what: str = "fused kernel") -> tuple:
    """Compile ``source`` (with ``csrc/`` on the include path) into a shared
    library under ``root/<hash>/``; reuse it when the hash matches (the
    hash covers the source, every ``csrc/*.cuh`` header, the compiler and
    the flags).  Returns ``(path, compiler_log)``."""
    compiler = compiler or _nvcc()
    headers = [p.read_text() for p in sorted(CSRC.glob("*.cuh"))]
    key = hashlib.sha256("\0".join(
        [source, *headers, Path(compiler).name, *flags]).encode()).hexdigest()
    out_dir = root / key[:16]
    lib = out_dir / "fused.so"
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused.cu"
    src.write_text(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [compiler, *flags, "-I", str(CSRC), "-o", tmp, str(src)]
    with span("srk.build.nvcc"):
        EVENTS["nvcc"] += 1
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building the {what} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, log


P = ctypes.c_void_p
I = ctypes.c_int


def csrc(filename: str) -> str:
    """The text of a source under ``csrc/``."""
    return (CSRC / filename).read_text()


class CudaLib:
    """One kernel's source, its build and its launch count."""

    def __init__(self, name: str, source: str, what: str):
        self.name = name            # the kernel's name in chip_smoke's record
        self.source = source
        self.what = what
        self.launches = 0           # launch() adds one per call
        self.by_entry = {}          # ... and one to its entry's count
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self):
        """Build (or reuse) and load the library."""
        with self._lock:
            if self._lib is None:
                path, self.build_log = build(self.source, what=self.what)
                with span("srk.build.load"):
                    self._lib = ctypes.CDLL(str(path))
                    EVENTS["load"] += 1
        return self._lib

    def launch(self, entry: str, argtypes: list, args: tuple,
               device: torch.device) -> None:
        """Call ``entry(*args, stream)`` on ``device``'s current stream;
        raise if the launch failed; count it."""
        lib = self.build()
        with span("srk.launch"):
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes) + [P]
            fn.restype = I
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.what} launch failed ({entry}): CUDA "
                               f"error {err}")
        self.launches += 1
        self.by_entry[entry] = self.by_entry.get(entry, 0) + 1


def require_cuda(*tensors) -> torch.device:
    """The one CUDA device that every tensor lies on, contiguous; raises
    otherwise (a kernel wrapper never falls back to its plain version)."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"the kernel takes CUDA tensors on one device; "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return device
