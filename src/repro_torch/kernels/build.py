"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (one process per
source, in parallel) and links them into one shared library with a plain C
interface, which ``ctypes`` loads. The library is
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing build. The build directory
(``kernels/build/``) is listed in ``.gitignore``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "repro_topk_combine": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_grouped_gemm": (_P, _LL, _LL, _P, _LL, _LL, _P,
                           _I, _I, _I, _I, _I, _I, _P),
    "repro_grouped_gemm_hopper": (_P, _LL, _LL, _P, _LL, _LL, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_fused_mlp": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL, _LL, _P,
                        _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_fused_mlp_chunk": (),
    "repro_fused_mlp_hopper": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL, _LL,
                               _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_fused_mlp_dgrad": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL, _LL,
                              _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    "repro_fused_mlp_dgrad_chunk": (),
    "repro_fused_mlp_dgrad_hopper": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL,
                                     _LL, _P, _LL, _LL, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _P),
    "repro_fused_mlp_wgrad": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL, _LL,
                              _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _P),
    "repro_fused_mlp_wgrad_tile": (_I,),
    "repro_fused_mlp_wgrad_hopper": (_P, _LL, _LL, _P, _P, _LL, _LL, _P, _LL,
                                     _LL, _P, _LL, _LL, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _I, _P),
    "repro_flash_attention": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL,
                              _P, _LL, _LL, _LL, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P),
    "repro_flash_attention_hopper": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL,
                                     _P, _LL, _LL, _LL, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _P),
    "repro_ssd_forward": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P,
                          _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_ssd_forward_hopper": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P,
                                 _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P),
    "repro_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P),
}
# each source's attribute query (csrc/attrs.cuh): (instance, out, label, cap)
ATTR_QUERIES = tuple(f"repro_attrs_{p.stem}"
                     for p in sorted(CSRC.glob("*.cu")))
SIGNATURES.update({q: (_I, _P, _P, _I) for q in ATTR_QUERIES})


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float          # 0.0 when an existing build was loaded
    log: str                # nvcc's output (ptxas register/smem report)

    def check(self, name: str, err: int) -> None:
        """Raise if a launch returned a CUDA error."""
        if err:
            msg = self.lib.repro_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """One nvcc per source, all started together, then one link into a
    shared library. Returns nvcc's output (ptxas register/smem report)."""
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib = out_dir / "lib.so"
    proc = subprocess.run([nvcc, "-shared", "-o", str(lib),
                           *(str(o) for _, o, _ in procs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{proc.stdout}{proc.stderr}")
    return "\n".join(log)


@functools.lru_cache(maxsize=1)
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library once per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libreprokernels_{source_hash()}.so"
    build_s, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _compile(Path(tmp))
            os.replace(Path(tmp) / "lib.so", path)   # never a half-written .so
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, build_s, log)


def kernel_attributes(lib: KernelLibrary) -> list:
    """Every compiled kernel instance's attributes, as each source's query
    reports them (``csrc/attrs.cuh``): a dict per instance with its
    source, label ("<model names>|<input dtype>|<template arguments>"),
    registers a thread, static shared bytes, local (spill) bytes a thread
    and the most threads a block may have."""
    out = []
    vals = (ctypes.c_int * 4)()
    label = ctypes.create_string_buffer(256)
    for q in ATTR_QUERIES:
        fn = getattr(lib.lib, q)
        i = 0
        while True:
            err = fn(i, ctypes.cast(vals, ctypes.c_void_p),
                     ctypes.cast(label, ctypes.c_void_p), len(label))
            if err == -1:
                break
            lib.check(q, err)
            out.append({"source": q[len("repro_attrs_"):] + ".cu",
                        "label": label.value.decode(), "regs": vals[0],
                        "static_smem": vals[1], "local_bytes": vals[2],
                        "max_threads": vals[3]})
            i += 1
    return out


def dtype_code(name: str, *tensors) -> int:
    """0 = fp32, 1 = bf16 for tensors that all share that dtype; raise on
    anything else."""
    dts = {t.dtype for t in tensors}
    if len(dts) != 1:
        raise TypeError(f"{name}: operands have mixed dtypes {dts}")
    dt = dts.pop()
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise TypeError(f"{name}: dtype {dt} not supported (fp32 or bf16)")


def require_cuda(name: str, *tensors) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: all operands must be on one CUDA device, "
                         f"got {devs}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
