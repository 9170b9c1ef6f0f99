"""The plan of the port's tensor-core GEMMs: output tiles and the split of
the reduction, as the kernels read them from their block index.

Shared by the bfloat16 GEMM of ``csrc/ffn_mma.cu`` (the FFN's fc1 and fc2,
and the backward's dh1; k tiles of 64 values) and the int8 GEMM of
``csrc/ffn_int8.cu`` (64-row tiles, k tiles of 128 values). Both cut the
output into tiles of 128 columns; a launch is a grid of (col_tiles,
row_tiles, splits) blocks, split z reducing k tiles [z per, (z + 1) per),
and a split launch is followed by a pass that sums the partials in split
order.
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
    is empty (covering every SM twice, as the float32 FFN kernel's
    ``ffn_splits`` does, was slower on an H100 at 256 and 2,048 rows in a
    development comparison). The kernels refuse a plan that leaves a k tile
    out or a split empty."""
    row_tiles = -(-m // row_tile)
    col_tiles = -(-n // GEMM_TILE)
    k_tiles = -(-k // k_tile)
    splits = max(1, min(k_tiles,
                        -(-num_sms // (row_tiles * col_tiles))))
    per = -(-k_tiles // splits)
    return GemmPlan(row_tiles, col_tiles, -(-k_tiles // per), per)


def gemm_blocks(plan: GemmPlan, m: int, n: int, k: int,
                k_tile: int = GEMM_K_TILE, row_tile: int = GEMM_TILE):
    """Yield each block's (split, rows, columns, k range) as the kernel
    computes them from its block index, clipped to the matrix."""
    k_tiles = -(-k // k_tile)
    for z in range(plan.splits):
        kt0 = z * plan.per
        nkt = min(plan.per, k_tiles - kt0)
        for y in range(plan.row_tiles):
            for x in range(plan.col_tiles):
                yield (z, range(y * row_tile, min(m, (y + 1) * row_tile)),
                       range(x * GEMM_TILE, min(n, (x + 1) * GEMM_TILE)),
                       range(kt0 * k_tile, min(k, (kt0 + nkt) * k_tile)))


def check_mma_operands(what: str, h: int, inter: int,
                       *tensors: torch.Tensor, multiple: int = 8) -> None:
    """The tensor-core kernels copy whole 16-byte chunks of rows: H and I
    must be multiples of ``multiple`` (8 bfloat16 values, 16 int8 values),
    and every operand 16-byte aligned."""
    if h % multiple or inter % multiple:
        raise ValueError(f"{what}: needs H and I multiples of {multiple}, "
                         f"got H={h}, I={inter}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
