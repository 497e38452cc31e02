"""Build the port's hand-written CUDA kernels and bind them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.
``nvcc`` compiles it for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout (a directory that
``.gitignore`` lists), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
is built or loaded when a module is imported: the first launch (or
:func:`build_all`) does it.

Every C entry point takes device pointers, ints and PyTorch's current
stream, launches, and returns ``cudaGetLastError()``; :meth:`CudaKernel.
launch` raises when that is not 0. Floating point is built with IEEE
division (``-prec-div=true``, never ``--use_fast_math``): the chunk step's
cycle math must round exactly as the JAX reference does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-prec-div=true",
              "-Xptxas", "-v")
# REPRO_KERNEL_DEBUG=1 adds a bounded spin to every mbarrier wait, which
# traps (a launch error) instead of hanging the card.
DEBUG_FLAGS = ("-DREPRO_HANG_TRAP",)


def nvcc_flags() -> tuple[str, ...]:
    debug = os.environ.get("REPRO_KERNEL_DEBUG") == "1"
    return NVCC_FLAGS + (DEBUG_FLAGS if debug else ())

# ctypes argument kinds of the C entry points.
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float

# The ``dtype`` argument of the attention and RWKV entry points.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, *tensors: torch.Tensor) -> int:
    """The entry points' code for the one floating type of ``tensors``;
    raises TypeError on mixed or unsupported types."""
    types = {t.dtype for t in tensors}
    if len(types) != 1 or next(iter(types)) not in DTYPE_CODE:
        raise TypeError(f"{name} takes all-float32 or all-bfloat16 inputs, "
                        f"got {sorted(map(str, types))}")
    return DTYPE_CODE[types.pop()]


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise ValueError unless every tensor is contiguous on one CUDA
    device; returns that device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} needs all its tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return devices.pop()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One CUDA source, its shared library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one for
    every launch of the kernel and that nothing else touches; callers
    reset it to 0 (or call :meth:`reset`) to count the launches of one
    run. A kernel with ``variants`` has an entry point that reports the
    path it took through one more argument, an ``int*`` before the
    stream, and :meth:`launch` counts that too, in ``variant_launches``.
    ``defines`` are extra ``nvcc`` options (``-D...``) of this build: one
    source built twice is two kernels, each with its library and count.
    ``entries`` maps further C entry points of the same library to their
    argument kinds; ``launch(..., symbol=...)`` launches one of them, and
    its launches count in the same ``launches``.
    """

    def __init__(self, name: str, symbol: str, argtypes: tuple,
                 variants: tuple[str, ...] = (),
                 defines: tuple[str, ...] = (),
                 entries: dict[str, tuple] | None = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.variants = variants
        self.defines = defines
        self.entries = {symbol: argtypes, **(entries or {})}
        self.source = CSRC / f"{name}.cu"
        self.launches = 0
        self.variant_launches = dict.fromkeys(variants, 0)
        self.build_log = ""
        self._fns = {}

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = dict.fromkeys(self.variants, 0)

    @property
    def flags(self) -> tuple[str, ...]:
        return nvcc_flags() + self.defines

    @property
    def library(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` on this source unless its library exists;
        returns the running process (None when nothing to build)."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
        os.replace(tmp, self.library)
        self.library.with_suffix(".log").write_text(out)

    def build(self) -> None:
        self.finish_build(self.start_build())

    def _load(self, symbol: str):
        if symbol not in self._fns:
            self.build()
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, symbol)
            extra = [ctypes.POINTER(ctypes.c_int)] if self.variants else []
            fn.argtypes = list(self.entries[symbol]) + extra + [PTR]  # stream
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def query(self, device: torch.device, symbol: str, *args) -> int:
        """Call the C entry point ``symbol``, which launches nothing, on
        ``device``; raise if it returns an error. Returns the int that a
        kernel with ``variants`` reports through its ``int*`` (-1 for
        one without). Counts no launch."""
        fn = self._load(symbol)
        stream = torch.cuda.current_stream(device).cuda_stream
        which = ctypes.c_int(-1)
        extra = (ctypes.byref(which),) if self.variants else ()
        with torch.cuda.device(device):
            err = fn(*args, *extra, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name}: {symbol} failed: cudaError {err}")
        return which.value

    def launch(self, device: torch.device, *args,
               symbol: str | None = None) -> None:
        """Launch on ``device``'s current PyTorch stream; raise if the
        launch was refused. ``args`` are ints for the C entry point
        ``symbol`` (the kernel's own by default; pointers as
        ``tensor.data_ptr()``)."""
        fn = self._load(symbol or self.symbol)
        stream = torch.cuda.current_stream(device).cuda_stream
        which = ctypes.c_int(-1)
        extra = (ctypes.byref(which),) if self.variants else ()
        with torch.cuda.device(device):
            err = fn(*args, *extra, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1
        if self.variants:
            self.variant_launches[self.variants[which.value]] += 1


def build_all(kernels) -> None:
    """Build several kernels at once: one ``nvcc`` per source, all started
    together, then all waited for."""
    procs = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, p in procs:
        try:
            k.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
