"""Build, load and call the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, named under ``_build/`` by the
content hash of the source and of every ``csrc/*.cuh`` header (so an
edited source or header rebuilds and an unchanged tree is reused), and
loaded with ctypes on first use.  Nothing here runs at
import time: the CPU tests import every module, and this machine may have
no ``nvcc`` and no card.

The wrappers check their tensors with ``check_tensor`` before any launch
and raise through ``check_launch`` when a launch returns a CUDA error.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def source_digest(source, csrc=CSRC):
    """Content hash of a kernel source together with every header in
    ``csrc`` (``*.cuh``), each under its file name: a source may include
    any of them, so an edited header must change the digest."""
    h = hashlib.sha1()
    for path in [source] + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0")
            h.update(hashlib.sha1(f.read()).digest())
    return h.hexdigest()[:16]


class CudaLibrary:
    """One ``csrc/<name>.cu`` as a ctypes library, built on first use.

    ``bind(lib)`` declares the argument and result types of the library's
    C functions.  ``define`` (a preprocessor macro, or None) builds another
    library from the same source with ``-D<define>``, kept under its own
    name."""

    def __init__(self, name, bind, csrc=CSRC, define=None):
        self.name = name
        self.csrc = csrc
        self.source = os.path.join(csrc, f"{name}.cu")
        self.define = define
        self.label = f"{name}.cu" + (f" -D{define}" if define else "")
        self._bind = bind
        self.lib = None
        self.build_seconds = None
        self.build_log = ""

    def get(self):
        if self.lib is None:
            self._build()
        return self.lib

    def path(self):
        """The built library's path, named by ``source_digest``."""
        digest = source_digest(self.source, self.csrc)
        stem = self.name + (f"-{self.define}" if self.define else "")
        return os.path.join(BUILD_DIR, f"{stem}_{digest}.so")

    def _build(self):
        path = self.path()
        t0 = time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            tmp = f"{path}.{os.getpid()}.tmp"
            out = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", tmp, self.source]
                + ([f"-D{self.define}"] if self.define else []),
                capture_output=True, text=True)
            self.build_log = out.stdout + out.stderr
            if out.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {self.source}:\n{self.build_log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        self._bind(lib)
        self.build_seconds = time.perf_counter() - t0
        self.lib = lib


def check_tensor(name, x, shape, dtype, device):
    """Raise ValueError unless ``x`` has this shape, dtype and device and
    is contiguous (what a kernel reading raw pointers needs)."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_request(smem_bytes):
    """Raise ValueError for a negative shared memory request (bytes)."""
    if smem_bytes < 0:
        raise ValueError(f"smem_bytes must be >= 0, got {smem_bytes}")


def on_card(x, name):
    """True for a CUDA tensor, False for a CPU tensor; raise otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def stream(device):
    """PyTorch's current CUDA stream on ``device``, as the C interfaces
    take it."""
    return torch.cuda.current_stream(device).cuda_stream


def occupancy(fn, what, *args):
    """A launch's occupancy from a library's ``*_occupancy(*args, &smem,
    &threads, &blocks, &regs, &local)`` query: its dynamic shared memory
    bytes, threads, blocks an SM holds, registers a thread and local
    memory bytes a thread (spills)."""
    out = [ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_int(), ctypes.c_longlong()]
    check_launch(fn(*args, *[ctypes.byref(x) for x in out]), what)
    return dict(zip(("smem_bytes", "threads", "blocks_per_sm", "registers",
                     "local_bytes"), (x.value for x in out)))


def check_launch(err, what):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
