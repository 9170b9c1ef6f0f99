"""The plan of the port's tiled GEMMs: output tiles and the split of the
reduction, as the kernels read them from their block index.

Shared by the bfloat16 GEMM of ``csrc/ffn_mma.cu`` (the FFN's fc1 and fc2,
and the backward's dh1; k tiles of 64 values) and the int8 GEMM of
``csrc/ffn_int8.cu`` (64-row tiles, k tiles of 128 values). Both cut the
output into tiles of 128 columns; a launch is a grid of (col_tiles,
row_tiles, splits) blocks, split z reducing k tiles [z per, (z + 1) per),
and a split launch is followed by a pass that sums the partials in split
order. The float32 GEMM of ``csrc/ffn.cu`` (the FFN's fc1 and fc2, and
the backward's dh1) never splits its reduction (:func:`f32_gemm_tile`
picks its output tile).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GEMM_TILE = 128         # columns, and rows of the bfloat16 GEMM
GEMM_K_TILE = 64        # bfloat16 (csrc/ffn_mma.cu)
INT8_ROW_TILE = 64      # int8 (csrc/ffn_int8.cu)
INT8_K_TILE = 128       # int8: the same 128-byte rows


class GemmPlan(NamedTuple):
    """One launch of a tensor-core GEMM, C [m, n] = A [m, k] B [k, n]: a
    grid of (col_tiles, row_tiles, splits) blocks, split z reducing k tiles
    [z per, (z + 1) per)."""
    row_tiles: int
    col_tiles: int
    splits: int
    per: int


def gemm_plan(m: int, n: int, k: int, num_sms: int,
              k_tile: int = GEMM_K_TILE,
              row_tile: int = GEMM_TILE) -> GemmPlan:
    """The GEMM's tiles and reduction split: enough splits that the grid
    covers every SM about once when the output has too few tiles (few
    rows), at most one k tile per split; then evened out so that no split
    is empty (covering every SM twice was slower for the bfloat16 GEMM on
    an H100 at 256 and 2,048 rows in a development comparison). The
    kernels refuse a plan that leaves a k tile out or a split empty."""
    row_tiles = -(-m // row_tile)
    col_tiles = -(-n // GEMM_TILE)
    k_tiles = -(-k // k_tile)
    splits = max(1, min(k_tiles,
                        -(-num_sms // (row_tiles * col_tiles))))
    per = -(-k_tiles // splits)
    return GemmPlan(row_tiles, col_tiles, -(-k_tiles // per), per)


# the float32 GEMM's output tiles, (rows, columns): 128 x 128 of 256
# threads (8 x 8 outputs each), and for few rows 16 x 8 and 32 x 32 of
# 128 threads (one output and 2 x 4 outputs each)
F32_WIDE = (128, 128)
F32_NARROW = ((16, 8), (32, 32))
F32_ONE_OUTPUT_MAX = 65536     # outputs of a GEMM given one a thread


def f32_gemm_tile(m: int, n: int, num_sms: int) -> tuple:
    """The float32 GEMM's (``csrc/ffn.cu``) output tile, (rows, columns),
    for C [m, n] (fc1, fc2; dh1 takes fc1's): 128 x 128 where that grid
    has a block for every other SM; else 16 x 8, one output a thread, up
    to ``F32_ONE_OUTPUT_MAX`` outputs, and 32 x 32 past them, so that few
    rows still spread over the card. The reduction is never split: every output is one FMA chain
    over k in order in any tile, so a row's bits do not depend on the
    tile, nor on how many rows share the launch."""
    if -(-m // F32_WIDE[0]) * -(-n // F32_WIDE[1]) >= num_sms // 2:
        return F32_WIDE
    return F32_NARROW[0] if m * n <= F32_ONE_OUTPUT_MAX else F32_NARROW[1]


def gemm_blocks(plan: GemmPlan, m: int, n: int, k: int,
                k_tile: int = GEMM_K_TILE, row_tile: int = GEMM_TILE,
                col_tile: int = GEMM_TILE):
    """Yield each block's (split, rows, columns, k range) as the kernel
    computes them from its block index, clipped to the matrix."""
    k_tiles = -(-k // k_tile)
    for z in range(plan.splits):
        kt0 = z * plan.per
        nkt = min(plan.per, k_tiles - kt0)
        for y in range(plan.row_tiles):
            for x in range(plan.col_tiles):
                yield (z, range(y * row_tile, min(m, (y + 1) * row_tile)),
                       range(x * col_tile, min(n, (x + 1) * col_tile)),
                       range(kt0 * k_tile, min(k, (kt0 + nkt) * k_tile)))


def check_mma_operands(what: str, h: int, inter: int,
                       *tensors: torch.Tensor, multiple: int = 8) -> None:
    """The tensor-core kernels (and the float32 dh1) copy whole 16-byte
    chunks of rows: H and I must be multiples of ``multiple`` (8 bfloat16
    values, 16 int8 values, 4 float32 values), and every operand 16-byte
    aligned."""
    if h % multiple or inter % multiple:
        raise ValueError(f"{what}: needs H and I multiples of {multiple}, "
                         f"got H={h}, I={inter}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
