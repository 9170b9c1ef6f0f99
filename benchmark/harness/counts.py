"""Operations and bytes of the model's work, counted from shapes.

A model's FLOPs (the ``mfu`` metrics) count only real tokens, so that the
work spent on padding shows as a lower share; a kernel's operations and
bytes (the ``_roofline`` metrics) count the shapes the kernel was handed.
An operation is a multiply or an add (a multiply-add is two). Bytes count
each input read once and each output written once; a kernel's own
workspace is not counted.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

Work = Tuple[float, float]      # (bytes, operations)


def layer_flops(s: int, h: int, inter: int) -> float:
    """Forward FLOPs of one post-LN BERT layer over a sequence of ``s``
    real tokens: the four h x h products, the FFN and attention's two
    products over the real keys."""
    return s * (8.0 * h * h + 4.0 * h * inter) + 4.0 * s * s * h


def region_embedding_flops(n: int, h: int, img_dim: int,
                           pos_dim: int) -> float:
    """The region feature and box products of ``n`` regions."""
    return 2.0 * n * h * (img_dim + pos_dim)


def projection_flops(h: int, project_dim: int) -> float:
    """LightningDOT's projection of one [CLS] row: h -> 2h -> out."""
    return 2.0 * (h * 2 * h + 2 * h * project_dim)


def tower_flops(lens: Iterable[int], cfg: dict, project_dim: int,
                regions: bool) -> float:
    """Forward FLOPs of a tower over sequences of the given real lengths;
    an image sequence is its [CLS] and its regions."""
    h, i, n = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    total = 0.0
    for s in lens:
        s = int(s)
        total += n * layer_flops(s, h, i) + projection_flops(h, project_dim)
        if regions:
            total += region_embedding_flops(s - 1, h, cfg["img_dim"],
                                            cfg["pos_dim"])
    return total


def ffn_forward(rows: int, h: int, inter: int, elem: int,
                with_h1: bool) -> List[Work]:
    """fc1 (bias and GELU in its epilogue, writing gelu(h1) and, for a
    backward, h1) and fc2, each a GEMM of ``rows`` rows; biases float32."""
    fc1_out = rows * inter * elem * (2 if with_h1 else 1)
    fc1 = (elem * (rows * h + h * inter) + 4 * inter + fc1_out,
           2.0 * rows * h * inter)
    fc2 = (elem * (rows * inter + inter * h) + 4 * h + elem * rows * h,
           2.0 * rows * inter * h)
    return [fc1, fc2]


def ffn_dh1(rows: int, h: int, inter: int, elem: int) -> Work:
    """dh1 = (g W2^T) * gelu'(h1): reads g, h1 and W2, writes dh1."""
    return (elem * (rows * h + rows * inter + inter * h + rows * inter),
            2.0 * rows * h * inter)


def attention_forward(b: int, s: int, h: int, elem: int) -> Work:
    """Attention of ``b`` sequences of ``s`` rows, heads of any width:
    q k^T and p v, 4 b s^2 h operations; reads q, k, v and the float32 key
    bias, writes the context."""
    return (elem * 4 * b * s * h + 4 * b * s, 4.0 * b * s * s * h)
