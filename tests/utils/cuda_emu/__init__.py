"""Build one of the port's CUDA sources (ninpol_tpu_torch/csrc/*.cu) for
the CPU, so that a test can run the kernel's own code without nvcc or a
card: the source is rewritten into C++ (dynamic ``extern __shared__``
arrays become the emulator's block buffer, static ``__shared__`` arrays
function statics, ``kernel<<<...>>>(...)`` a call of ``emu_launch``) and
compiled by g++ against this directory's ``cuda_runtime.h``, which runs
each CUDA thread as an OS thread.  The library keeps the source's C
interface, so the port's ctypes bindings apply to it, with CPU pointers
and a null stream."""
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
    text = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);",
                  text, flags=re.S)
    return text


def gxx():
    return shutil.which("g++")


def build(name, out_dir, bind):
    """csrc/<name>.cu as an emulated ctypes library in out_dir, with its
    C functions declared by ``bind`` (the port module's ``_bind``)."""
    for f in os.listdir(CSRC):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f)) as src:
                text = to_cpp(src.read())
            with open(os.path.join(out_dir, f), "w") as dst:
                dst.write(text)
    so = os.path.join(out_dir, f"{name}_emu.so")
    cmd = [gxx(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-x", "c++", "-I", HERE, "-I", out_dir, "-o", so,
           os.path.join(out_dir, f"{name}.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {name}.cu:\n{out.stderr}")
    lib = ctypes.CDLL(so)
    bind(lib)
    return lib
