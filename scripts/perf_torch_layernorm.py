#!/usr/bin/env python3
"""Time the tunables of the port's LayerNorm kernels on one CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/perf_torch_layernorm.py

1. The forward's layout threshold (``kFewRows`` in
   ``lightningdot_tpu_torch/csrc/layernorm.cu``): the source as it is, and
   two copies built with the threshold at 0 (a warp per row at every row
   count) and at 2**30 (a block per row at every row count), each into its
   own library; bf16 [rows, 768], plain and with res and a rate-0.1 mask,
   at 32-4,096 rows, in the order as-is, warp, block, then reversed.
2. The backward's blocks per SM (``ops/layernorm.py::BWD_BLOCKS_PER_SM``)
   at 1-4: bf16 and float32 at 130, 2,048 and 4,096 rows, without res and
   with res and a mask.

Times are chip_smoke.py's ``time_ms`` (ten calls in a CUDA graph, the
median of seven replays, inputs L2-warm), one JSON line per row, with the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from lightningdot_tpu_torch.ops import _build  # noqa: E402
from lightningdot_tpu_torch.ops import layernorm as ln  # noqa: E402

FEW = "constexpr int kFewRows = 1024;"
LAYOUTS = {"as_is": FEW, "warp": "constexpr int kFewRows = 0;",
           "block": "constexpr int kFewRows = 1 << 30;"}


def build_variants(tmp: Path) -> dict:
    """{layout: path of a library built from layernorm.cu with it}."""
    src = (_build.CSRC / "layernorm.cu").read_text()
    if FEW not in src:
        raise SystemExit(f"layernorm.cu has no line {FEW!r}")
    (tmp / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    procs = {}
    for name, line in LAYOUTS.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(src.replace(FEW, line))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
    return {name: tmp / f"{name}.so" for name in LAYOUTS}


def use_library(path: Path) -> None:
    """Point the wrappers at a variant's library."""
    handle = ctypes.CDLL(str(path))
    for fn in ("ldot_layernorm", "ldot_layernorm_bwd"):
        getattr(handle, fn).argtypes = list(_build._SIGNATURES[fn])
        getattr(handle, fn).restype = ctypes.c_int
    handle.ldot_error_string.argtypes = [ctypes.c_int]
    handle.ldot_error_string.restype = ctypes.c_char_p
    _build._lib = handle


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_torch_layernorm: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    name = torch.cuda.get_device_name(0)
    print(chip_smoke.smi_line(), flush=True)

    def inputs(n, dtype):
        x, res, g = (torch.randn(n, 768, device=dev, generator=gen)
                     .to(dtype) for _ in range(3))
        keep = torch.rand(n, 768, device=dev, generator=gen) < 0.9
        scale = torch.rand(768, device=dev, generator=gen) + 0.5
        bias = torch.randn(768, device=dev, generator=gen)
        return x, res, g, keep, scale, bias

    def timed(fn, *args):
        return chip_smoke.time_ms(lambda: fn(*args))

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        order = list(LAYOUTS)
        for rnd, layouts in enumerate((order, order[::-1])):
            for layout in layouts:
                use_library(libs[layout])
                for n in (32, 128, 256, 512, 1024, 2048, 4096):
                    x, res, _, keep, scale, bias = inputs(n, torch.bfloat16)
                    plain = timed(ln.layer_norm_cuda, x, scale, bias, 1e-12)
                    masked = timed(ln.layer_norm_cuda, x, scale, bias, 1e-12,
                                   res, keep, 0.1)
                    print(json.dumps(dict(
                        phase="layout", round=rnd, layout=layout, rows=n,
                        dtype="bfloat16", plain_ms=plain,
                        res_keep_ms=masked, device=name)), flush=True)
        use_library(libs["as_is"])
        for per_sm in (1, 2, 3, 4):
            ln.BWD_BLOCKS_PER_SM = per_sm
            for dtype in (torch.bfloat16, torch.float32):
                for n in (130, 2048, 4096):
                    x, res, g, keep, scale, _ = inputs(n, dtype)
                    plain = timed(ln.layer_norm_bwd_cuda, x, scale, g,
                                  1e-12)
                    masked = timed(ln.layer_norm_bwd_cuda, x, scale, g,
                                   1e-12, res, keep, 0.1)
                    print(json.dumps(dict(
                        phase="bwd_blocks", blocks_per_sm=per_sm, rows=n,
                        dtype=str(dtype).replace("torch.", ""),
                        ln_ms=plain, res_keep_ms=masked, device=name)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
