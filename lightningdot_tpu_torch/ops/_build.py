"""Build and load the port's CUDA kernels.

All sources under ``lightningdot_tpu_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
``csrc/build/libldot_kernels.so``, which is loaded with ``ctypes``. The build
runs at first use, under an exclusive file lock (processes that start
together never load a half-written library), and again whenever a source is
newer than the library. Each source compiles in its own ``nvcc`` process,
all started together; one more ``nvcc`` links them. ptxas's report of each
kernel's registers, shared memory and spills is kept beside the objects,
``csrc/build/<source>.log`` (:func:`ptxas_report`).

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
LIB_PATH = BUILD_DIR / "libldot_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# dtype codes of the C interface (csrc/common.cuh: ldot::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # x, res, keep, scale, bias, out, rows, hidden, eps, keep_scale, dtype,
    # stream
    "ldot_layernorm": (_P,) * 6 + (_I, _I, _F, _F, _I, _P),
    # x, res, keep, scale, g, du, dx, partial, dscale, dbias, rows, hidden,
    # blocks, eps, keep_scale, dtype, stream
    "ldot_layernorm_bwd": (_P,) * 10 + (_I, _I, _I, _F, _F, _I, _P),
    # q, k, v, bias, out, batch, seq, heads, head_dim, scale, defer, dtype,
    # stream
    "ldot_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, w1, b1, w2, b2, out, h1, inter, rows, H, I, rows1, cols1, rows2,
    # cols2, stream (float32)
    "ldot_ffn": (_P,) * 8 + (_I,) * 7 + (_P,),
    # x, w1, b1, w2, b2, out, h1, inter, workspace, rows, H, I, splits1,
    # per1, splits2, per2, stream (bfloat16)
    "ldot_ffn_mma": (_P,) * 9 + (_I,) * 7 + (_P,),
    # g, h1, w2, w2t (workspace), dh1, rows, H, I, tile_rows, tile_cols,
    # stream (float32)
    "ldot_ffn_dh1": (_P,) * 5 + (_I,) * 5 + (_P,),
    # g, h1, w2, dh1, workspace, rows, H, I, splits, per, stream (bfloat16)
    "ldot_ffn_dh1_mma": (_P,) * 5 + (_I,) * 5 + (_P,),
    # table, chunks, n_chunks, scale, step_size, lr, b1, 1 - b1, b2,
    # 1 - b2, eps, m_bf16, stream
    "ldot_adamw": (_P, _P, _I, _P, _F, _F, _F, _F, _F, _F, _F, _I, _P),
    # x, w1t, s1, b1, w2t, s2, b2, out, inter, tile_max, row_scale,
    # workspace, rows, H, I, cols, splits, per, stream
    "ldot_ffn_int8": (_P,) * 12 + (_I,) * 6 + (_P,),
    # q, k, v, bias, seed, out, batch, seq, heads, head_dim, scale, mscale,
    # thresh, dropout, dtype, stream
    "ldot_attention_train_fwd": (_P,) * 6 + (_I, _I, _I, _I, _F, _F, _U, _I,
                                             _I, _P),
    # q, k, v, bias, seed, g, dq, dk, dv, stats, batch, seq, heads,
    # head_dim, scale, mscale, mscale_f32, thresh, dropout, dtype, stream
    "ldot_attention_train_bwd": (_P,) * 10 + (_I, _I, _I, _I, _F, _F, _F, _U,
                                              _I, _I, _P),
    # x, scale, out, rows, hidden, eps, dtype, stream
    "ldot_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # x, scale, g, dx, partial, dscale, dbias_scratch, rows, hidden,
    # blocks, eps, dtype, stream
    "ldot_rmsnorm_bwd": (_P,) * 7 + (_I, _I, _I, _F, _I, _P),
    # q, k, v, key_ok, o, lse, batch, seq, heads, dqk, dv, scale, causal,
    # dtype, stream
    "ldot_mla_attention": (_P,) * 6 + (_I,) * 5 + (_F, _I, _I, _P),
    # q, k, v, o, g, key_ok, lse, dq, dk, dv, batch, seq, heads, dqk, dv,
    # scale, causal, dtype, stream
    "ldot_mla_attention_bwd": (_P,) * 10 + (_I,) * 5 + (_F, _I, _I, _P),
    # x, out, rows, heads, seq, dim, theta, inverse, dtype, stream
    "ldot_rope": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # kind, epi, a, a_map, b, b_map, offsets, groups, out, out2, out3, g_in,
    # u_in, m, n, k, grid_rows, stream
    "ldot_moe_gemm": (_I, _I) + (_P,) * 5 + (_I,) + (_P,) * 5 + (_I,) * 4
    + (_P,),
    # y, pos, w, topk, out, tokens, h, stream
    "ldot_moe_combine": (_P, _P, _P, _I, _P, _I, _I, _P),
    # g, order, w, topk, offsets, groups, out, rows, h, stream
    "ldot_moe_scatter_rows": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _P),
    # g, y, pos, topk, dw, tokens, h, stream
    "ldot_moe_route_grad": (_P, _P, _P, _I, _P, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last real build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in _sources() + sorted(CSRC.glob("*.cuh")))


def _compile() -> None:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate(timeout=900)
        (BUILD_DIR / f"{src.stem}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = LIB_PATH.with_suffix(f".so.tmp.{os.getpid()}")
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)], check=True, capture_output=True,
                   text=True, timeout=300)
    tmp.replace(LIB_PATH)   # atomic: a reader never sees a partial file


def build() -> Path:
    """Compile the kernels if any source is newer than the library."""
    global build_seconds
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            t0 = time.perf_counter()
            _compile()
            build_seconds = time.perf_counter() - t0
    return LIB_PATH


def ptxas_report(stem: str) -> dict:
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from the last build's ptxas report of ``csrc/<stem>.cu``."""
    report, name, spills = {}, None, (0, 0)
    for line in (BUILD_DIR / f"{stem}.log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            report[name] = (int(m.group(1)), *spills)
            name = None
    return report


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.ldot_error_string.argtypes = [ctypes.c_int]
        handle.ldot_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = lib().ldot_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (looked up once)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {t.dtype} "
                        f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: tensor on {t.device}; the kernel "
                             f"takes CUDA tensors only")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
