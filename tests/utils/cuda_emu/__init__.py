"""Build one of the port's CUDA sources (ninpol_tpu_torch/csrc/*.cu) for
the CPU, so that a test can run the kernel's own code without nvcc or a
card: the source is rewritten into C++ (dynamic ``extern __shared__``
arrays become the emulator's block buffer, static ``__shared__`` arrays
function statics, ``kernel<...><<<...>>>(...)`` a call of
``emu_launch``) and compiled by g++ against this directory's
``cuda_runtime.h``, which runs each warp as an OS thread and each of its
lanes as a fiber on it.  The library keeps the source's C interface, so
the port's ctypes bindings apply to it, with CPU pointers and a null
stream."""
import ctypes
import os
import re
import shutil
import subprocess

from ninpol_tpu_torch.ops.cuda_lib import CSRC

HERE = os.path.dirname(os.path.abspath(__file__))


def to_cpp(text):
    """A CUDA source or header as C++ for the emulator."""
    text = re.sub(r"extern __shared__ __align__\(16\) ([\w ]+?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", text)
    text = text.replace("__shared__ ", "static ")
    # the pipeline primitives are in the emulator's cuda_runtime.h
    text = text.replace("#include <cuda_pipeline.h>\n", "")
    # kernel<<<...>>>(...), the kernel's template arguments included
    text = re.sub(r"(\w+(?:<[^<>;()]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu_launch(\1, \2, \3);", text, flags=re.S)
    return text


def gxx():
    return shutil.which("g++")


def build(name, out_dir, bind, define=None):
    """csrc/<name>.cu as an emulated ctypes library in out_dir, with its
    C functions declared by ``bind`` (the port module's ``_bind``);
    ``define``, a macro the source is built with, as CudaLibrary's."""
    for f in os.listdir(CSRC):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f)) as src:
                text = to_cpp(src.read())
            with open(os.path.join(out_dir, f), "w") as dst:
                dst.write(text)
    stem = name + (f"-{define}" if define else "")
    return _compile(name, stem, out_dir, bind, define)


def build_text(text, name, out_dir, bind):
    """A CUDA source given as text (a test's own kernels, which may call
    the emulator's ``emu_*`` primitives directly or include csrc/'s
    headers), built as ``build`` builds a file of csrc/."""
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            with open(os.path.join(CSRC, f)) as src:
                header = to_cpp(src.read())
            with open(os.path.join(out_dir, f), "w") as dst:
                dst.write(header)
    with open(os.path.join(out_dir, f"{name}.cu"), "w") as dst:
        dst.write(to_cpp(text))
    return _compile(name, name, out_dir, bind)


def _compile(name, stem, out_dir, bind, define=None):
    so = os.path.join(out_dir, f"{stem}_emu.so")
    cmd = [gxx(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-x", "c++", "-I", HERE, "-I", out_dir, "-o", so,
           os.path.join(out_dir, f"{name}.cu")]
    if define:
        cmd.append(f"-D{define}")
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {name}.cu:\n{out.stderr}")
    lib = ctypes.CDLL(so)
    bind(lib)
    return lib
