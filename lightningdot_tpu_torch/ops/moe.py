"""SwiGLU feed-forward blocks over groups of rows: the routed experts a card
holds, the shared experts and the dense layer of the Moonlight tower
(``models/moonlight.py``). CUDA kernels (``csrc/moe_gemm.cu``) and their
plain PyTorch twins.

No TPU counterpart: the JAX package has no mixture of experts. The routing
(:func:`route`) sorts the (token, slot) choices that fall on held experts
by expert, on the device, and gives each group's rows by ``offsets``; a
layer's grid is fixed from the token count alone, so nothing waits for the
host. Every product is bfloat16 on the tensor cores with float32 sums,
rounded once to bfloat16 at the points the twins give:

    G, U = round(x W_gate^T), round(x W_up^T);  act = round(silu(G) U)
    Y = round(act W_down^T);  out[t] = round(sum_k w[t, k] Y[row(t, k)])

and, backward, dY rows = round(w g[t]), dact = round(dY W_down), dG =
round(dact U silu'(G)), dU = round(dact silu(G)), dx rows = round([dG | dU]
W_gu), dx[t] = round(sum_k dx rows), dw[t, k] = g[t] . Y[row(t, k)] in
float32, and each weight gradient round(sum over the group's rows).

Weights are stacked per group: ``w_gu`` [G, 2 I, H] (W_gate's I rows, then
W_up's) and ``w_down`` [G, H, I], as stored ([out, in]).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.utils import tracing

TILE_ROWS = 128          # the kernels' row tile (csrc/moe_gemm.cu kBM)
MAX_GROUPS = 64
# blocks along the row tiles: about this many blocks per SM in all
BLOCKS_PER_SM = 8
KINDS = {"rows_nk": 0, "rows_kn": 1, "weights": 2}
EPIS = {"store": 0, "swiglu": 1, "swiglu_bwd": 2}


class Routing(NamedTuple):
    """One layer's choices that fall on held experts, sorted by expert.

    ``order`` int32 [rows]: the slot (token x topk + k) of each sorted row;
    the rows from ``offsets[-1]`` on are unused. ``tok`` int32 [rows]: its
    token. ``offsets`` int32 [groups + 1]. ``pos`` int32 [tokens, topk]:
    each slot's sorted row, -1 where the slot's expert is not held (or the
    token is padding). ``rows``: tokens x min(topk, groups), the most rows
    a batch can send, known on the host."""
    order: torch.Tensor
    tok: torch.Tensor
    offsets: torch.Tensor
    pos: torch.Tensor
    rows: int
    topk: int


def route(sel: torch.Tensor, first: int, held: int,
          real: Optional[torch.Tensor] = None) -> Routing:
    """The :class:`Routing` of the chosen experts ``sel`` int64 [tokens,
    topk] on experts ``first`` ... ``first + held - 1``; ``real`` bool
    [tokens] leaves padding tokens out. Device ops only (a stable sort, a
    scatter-add, a cumulative sum): no host sync."""
    n, topk = sel.shape
    local = sel - first
    mine = (local >= 0) & (local < held)
    if real is not None:
        mine = mine & real[:, None]
    key = torch.where(mine, local, torch.full_like(local, held)).flatten()
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(held + 1, dtype=torch.int64, device=sel.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts[:held], 0)]).int()
    rows = n * min(topk, held)
    order = order[:rows]
    pos = torch.full((n * topk,), -1, dtype=torch.int64, device=sel.device)
    pos.scatter_(0, order, torch.arange(rows, device=sel.device))
    pos = torch.where(mine.flatten(), pos, torch.full_like(pos, -1))
    return Routing(order.int(), (order // topk).int(), offsets,
                   pos.view(n, topk).int(), rows, topk)


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def _spans(offsets: torch.Tensor):
    off = offsets.tolist()
    return list(zip(off[:-1], off[1:]))


def _rows_of(x, a_map, r0, r1):
    return x[r0:r1] if a_map is None else x[a_map[r0:r1].long()]


def gate_up_math(x, a_map, offsets, w_gu, rows):
    """(G, U, act) [rows, I] in x's dtype; rows past the groups are 0."""
    inter = w_gu.shape[1] // 2
    out = [x.new_zeros(rows, inter) for _ in range(3)]
    for g, (r0, r1) in enumerate(_spans(offsets)):
        gu = _rows_of(x, a_map, r0, r1).float() @ w_gu[g].float().t()
        gate = gu[:, :inter].to(x.dtype)
        up = gu[:, inter:].to(x.dtype)
        gf = gate.float()
        out[0][r0:r1], out[1][r0:r1] = gate, up
        out[2][r0:r1] = (gf * torch.sigmoid(gf) * up.float()).to(x.dtype)
    return tuple(out)


def rows_times_math(a, offsets, w, transpose: bool, rows):
    """[rows, n]: each group's rows of ``a`` times ``w[g]`` (``transpose``:
    ``w[g]^T``, the weight as stored read as [k][n] in the forward)."""
    n = w.shape[1] if transpose else w.shape[2]
    out = a.new_zeros(rows, n)
    for g, (r0, r1) in enumerate(_spans(offsets)):
        wg = w[g].float()
        out[r0:r1] = (a[r0:r1].float() @ (wg.t() if transpose else wg)
                      ).to(a.dtype)
    return out


def swiglu_bwd_math(dy, offsets, w_down, gate, up, rows):
    """[dG | dU] [rows, 2 I] from dact = round(dY W_down)."""
    inter = w_down.shape[2]
    out = dy.new_zeros(rows, 2 * inter)
    for g, (r0, r1) in enumerate(_spans(offsets)):
        da = (dy[r0:r1].float() @ w_down[g].float()).to(dy.dtype).float()
        gf, uf = gate[r0:r1].float(), up[r0:r1].float()
        s = torch.sigmoid(gf)
        out[r0:r1, :inter] = (da * uf * (s * (1.0 + gf * (1.0 - s)))
                              ).to(dy.dtype)
        out[r0:r1, inter:] = (da * (gf * s)).to(dy.dtype)
    return out


def weight_grad_math(a, b, b_map, offsets):
    """[groups, m, n]: sum over each group's rows of a^T b (b's rows
    through ``b_map``)."""
    groups = offsets.shape[0] - 1
    out = a.new_zeros(groups, a.shape[1], b.shape[1])
    for g, (r0, r1) in enumerate(_spans(offsets)):
        out[g] = (a[r0:r1].float().t() @ _rows_of(b, b_map, r0, r1).float()
                  ).to(a.dtype)
    return out


def combine_math(y, pos, w):
    """[tokens, h]: sum over slots of w[t, k] y[pos[t, k]] (w None: 1)."""
    n, topk = pos.shape
    acc = torch.zeros(n, y.shape[1], dtype=torch.float32, device=y.device)
    for k in range(topk):
        p = pos[:, k].long()
        ok = (p >= 0)[:, None]
        rows = y[p.clamp(min=0)].float()
        wk = 1.0 if w is None else w[:, k:k + 1]
        acc = acc + torch.where(ok, wk * rows, torch.zeros_like(rows))
    return acc.to(y.dtype)


def scatter_rows_math(g, routing: Routing, w):
    """[rows, h]: round(w[slot] g[token]) of each sorted row."""
    out = g.new_zeros(routing.rows, g.shape[1])
    total = int(routing.offsets[-1])
    order = routing.order[:total].long()
    out[:total] = (w.flatten()[order][:, None]
                   * g[order // routing.topk].float()).to(g.dtype)
    return out


def route_grad_math(g, y, pos):
    """float32 [tokens, topk]: g[t] . y[pos[t, k]], 0 where pos < 0."""
    p = pos.long()
    dots = (g.float()[:, None, :] * y[p.clamp(min=0)].float()).sum(-1)
    return torch.where(p >= 0, dots, torch.zeros_like(dots))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(what, *tensors):
    for t in tensors:
        if t is None:
            continue
        if t.dtype not in (torch.bfloat16, torch.int32, torch.float32):
            raise TypeError(f"{what}: {t.dtype}; the kernels take bfloat16 "
                            f"operands")
        if t.data_ptr() % 16 and t.dtype == torch.bfloat16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
    _build.require_cuda(what, *[t for t in tensors if t is not None])


def _gemm(kind, epi, a, a_map, b, b_map, offsets, out, out2=None, out3=None,
          g_in=None, u_in=None, m=0, n=0, k=0, rows=0):
    what = f"moe_gemm kernel ({kind}, {epi})"
    groups = offsets.shape[0] - 1
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"{what}: bfloat16 operands only, got {a.dtype}, "
                        f"{b.dtype}")
    if groups > MAX_GROUPS or n % 8 or k % 8 or m % 8:
        raise ValueError(f"{what}: groups <= {MAX_GROUPS} and widths "
                         f"multiples of 8; got {groups}, m={m}, n={n}, k={k}")
    _check(what, a, a_map, b, b_map, offsets, out, out2, out3, g_in, u_in)
    cols = (64 if epi == "swiglu" else 128)
    n_tiles = -(-n // cols)
    max_tiles = -(-rows // TILE_ROWS) + groups
    grid_rows = max(1, min(max_tiles, -(-BLOCKS_PER_SM
                                        * _build.num_sms(a.device)
                                        // n_tiles)))
    with torch.cuda.device(a.device):
        _build.check(_build.lib().ldot_moe_gemm(
            KINDS[kind], EPIS[epi], a.data_ptr(), _ptr(a_map), b.data_ptr(),
            _ptr(b_map), offsets.data_ptr(), groups, out.data_ptr(),
            _ptr(out2), _ptr(out3), _ptr(g_in), _ptr(u_in), m, n, k,
            grid_rows, _build.stream_ptr(a)), what)
    tracing.launched("moe_gemm")
    return out


def gate_up(x, a_map, offsets, w_gu, rows):
    """(G, U, act) [rows, I]: the gate/up GEMM with its SwiGLU epilogue."""
    if not x.is_cuda:
        return gate_up_math(x, a_map, offsets, w_gu, rows)
    inter = w_gu.shape[1] // 2
    gate, up, act = (torch.empty(rows, inter, dtype=x.dtype,
                                 device=x.device) for _ in range(3))
    _gemm("rows_nk", "swiglu", x, a_map, w_gu, None, offsets, gate, up, act,
          n=inter, k=x.shape[1], rows=rows)
    return gate, up, act


def down(act, offsets, w_down, rows):
    """Y [rows, H] = act W_down[g]^T."""
    if not act.is_cuda:
        return rows_times_math(act, offsets, w_down, True, rows)
    out = torch.empty(rows, w_down.shape[1], dtype=act.dtype,
                      device=act.device)
    return _gemm("rows_nk", "store", act, None, w_down, None, offsets, out,
                 n=w_down.shape[1], k=act.shape[1], rows=rows)


def swiglu_bwd(dy, offsets, w_down, gate, up, rows):
    """[dG | dU] [rows, 2 I]."""
    if not dy.is_cuda:
        return swiglu_bwd_math(dy, offsets, w_down, gate, up, rows)
    inter = w_down.shape[2]
    out = torch.empty(rows, 2 * inter, dtype=dy.dtype, device=dy.device)
    return _gemm("rows_kn", "swiglu_bwd", dy, None, w_down, None, offsets,
                 out, g_in=gate, u_in=up, n=inter, k=dy.shape[1], rows=rows)


def dx_rows(dgu, offsets, w_gu, rows):
    """[rows, H] = [dG | dU] W_gu[g]."""
    if not dgu.is_cuda:
        return rows_times_math(dgu, offsets, w_gu, False, rows)
    out = torch.empty(rows, w_gu.shape[2], dtype=dgu.dtype,
                      device=dgu.device)
    return _gemm("rows_kn", "store", dgu, None, w_gu, None, offsets, out,
                 n=w_gu.shape[2], k=dgu.shape[1], rows=rows)


def weight_grad(a, b, b_map, offsets):
    """[groups, m, n] = a_g^T b_g over each group's rows."""
    if not a.is_cuda:
        return weight_grad_math(a, b, b_map, offsets)
    groups = offsets.shape[0] - 1
    out = torch.empty(groups, a.shape[1], b.shape[1], dtype=a.dtype,
                      device=a.device)
    return _gemm("weights", "store", a, None, b, b_map, offsets, out,
                 m=a.shape[1], n=b.shape[1])


def combine(y, pos, w):
    if not y.is_cuda:
        return combine_math(y, pos, w)
    what = "moe_combine kernel"
    _check(what, y, pos, w)
    n, topk = pos.shape
    out = torch.empty(n, y.shape[1], dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        _build.check(_build.lib().ldot_moe_combine(
            y.data_ptr(), pos.data_ptr(), _ptr(w), topk, out.data_ptr(), n,
            y.shape[1], _build.stream_ptr(y)), what)
    tracing.launched("moe_combine")
    return out


def scatter_rows(g, routing: Routing, w):
    if not g.is_cuda:
        return scatter_rows_math(g, routing, w)
    what = "moe_scatter_rows kernel"
    _check(what, g, routing.order, routing.offsets, w)
    out = torch.empty(routing.rows, g.shape[1], dtype=g.dtype,
                      device=g.device)
    with torch.cuda.device(g.device):
        _build.check(_build.lib().ldot_moe_scatter_rows(
            g.data_ptr(), routing.order.data_ptr(), w.data_ptr(),
            routing.topk, routing.offsets.data_ptr(),
            routing.offsets.shape[0] - 1, out.data_ptr(), routing.rows,
            g.shape[1], _build.stream_ptr(g)), what)
    tracing.launched("moe_scatter_rows")
    return out


def route_grad(g, y, pos):
    if not g.is_cuda:
        return route_grad_math(g, y, pos)
    what = "moe_route_grad kernel"
    _check(what, g, y, pos)
    n, topk = pos.shape
    dw = torch.empty(n, topk, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        _build.check(_build.lib().ldot_moe_route_grad(
            g.data_ptr(), y.data_ptr(), pos.data_ptr(), topk, dw.data_ptr(),
            n, g.shape[1], _build.stream_ptr(g)), what)
    tracing.launched("moe_route_grad")
    return dw


# ---------------------------------------------------------------------------
# the blocks, with their gradients
# ---------------------------------------------------------------------------

def _all_rows(n: int, device) -> torch.Tensor:
    """offsets [0, n], made on the device (a copy from the host would
    wait for it)."""
    return torch.arange(2, dtype=torch.int32, device=device) * n


class _DenseSwiGLU(torch.autograd.Function):
    """One group of rows: every row of x, or the rows that ``rows`` (a
    :class:`Routing` of one held group and one slot) selects, gathered
    through its map and put back in place (the others' output 0). G, U
    and act are kept for the backward."""

    @staticmethod
    def forward(ctx, x, w_gu, w_down, name, rows):
        n = x.shape[0]
        offsets = _all_rows(n, x.device) if rows is None else rows.offsets
        a_map = None if rows is None else rows.tok
        ctx.name, ctx.rows = name, rows
        with tracing.span(name):
            gate, up, act = gate_up(x, a_map, offsets, w_gu[None], n)
            y = down(act, offsets, w_down[None], n)
            if rows is not None:
                y = combine(y, rows.pos, None)
        ctx.save_for_backward(x, w_gu, w_down, gate, up, act, offsets)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_gu, w_down, gate, up, act, offsets = ctx.saved_tensors
        rows = ctx.rows
        n = x.shape[0]
        g = g.contiguous()
        with tracing.span(ctx.name):
            if rows is not None:
                g = scatter_rows(g, rows, torch.ones(
                    n, dtype=torch.float32, device=g.device))
            dgu = swiglu_bwd(g, offsets, w_down[None], gate, up, n)
            dx = dx_rows(dgu, offsets, w_gu[None], n)
            if rows is not None:
                dx = combine(dx, rows.pos, None)
            dw_down = weight_grad(g, act, None, offsets)[0]
            dw_gu = weight_grad(dgu, x, None if rows is None else rows.tok,
                                offsets)[0]
        return dx, dw_gu, dw_down, None, None


def real_rows(real: torch.Tensor) -> Routing:
    """The :class:`Routing` that gathers the rows where ``real`` (bool
    [N]) holds, in order, as one group: padding's rows are left out of
    the token-wise blocks that take it."""
    return route(torch.zeros(real.shape[0], 1, dtype=torch.int64,
                             device=real.device), 0, 1, real)


def swiglu(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor,
           span: str = "ffn.dense",
           rows: Optional[Routing] = None) -> torch.Tensor:
    """W_down(silu(W_gate x) * W_up x) of the rows of x [N, H] (``w_gu``
    [2 I, H], ``w_down`` [H, I]) through the grouped kernels as one group
    (the dense layer, the shared experts), inside ``span`` in the forward
    and the backward: every row, or those of ``rows`` (:func:`real_rows`),
    the others' output 0."""
    return _DenseSwiGLU.apply(x.contiguous(), w_gu, w_down, span, rows)


class _RoutedExperts(torch.autograd.Function):
    """The held experts' rows, combined per token by the routing weights.
    G, U, act and Y are recomputed in the backward: they are sized for the
    most rows a batch could send, ``routing.rows``."""

    @staticmethod
    def forward(ctx, x, w, w_gu, w_down, routing):
        with tracing.span("moe.experts"):
            _, _, act = gate_up(x, routing.tok, routing.offsets, w_gu,
                                routing.rows)
            y = down(act, routing.offsets, w_down, routing.rows)
        with tracing.span("moe.combine"):
            out = combine(y, routing.pos, w.contiguous())
        ctx.save_for_backward(x, w, w_gu, w_down)
        ctx.routing = routing
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, w_gu, w_down = ctx.saved_tensors
        r = ctx.routing
        g = g.contiguous()
        with tracing.span("moe.experts"):
            gate, up, act = gate_up(x, r.tok, r.offsets, w_gu, r.rows)
            y = down(act, r.offsets, w_down, r.rows)
        with tracing.span("moe.route"):
            dw = route_grad(g, y, r.pos)
        with tracing.span("moe.combine"):
            dy = scatter_rows(g, r, w.contiguous())
        del y
        with tracing.span("moe.experts"):
            dgu = swiglu_bwd(dy, r.offsets, w_down, gate, up, r.rows)
            del gate, up
            dxr = dx_rows(dgu, r.offsets, w_gu, r.rows)
            dw_down = weight_grad(dy, act, None, r.offsets)
            dw_gu = weight_grad(dgu, x, r.tok, r.offsets)
        with tracing.span("moe.combine"):
            dx = combine(dxr, r.pos, None)
        return dx, dw, dw_gu, dw_down, None


def routed_experts(x: torch.Tensor, w: torch.Tensor, w_gu: torch.Tensor,
                   w_down: torch.Tensor, routing: Routing) -> torch.Tensor:
    """sum over held slots k of w[t, k] E_k(x[t]), E_k the SwiGLU of
    ``w_gu[e]`` [G, 2 I, H], ``w_down[e]`` [G, H, I], for x [N, H] and the
    routing weights w float32 [N, topk]."""
    return _RoutedExperts.apply(x.contiguous(), w, w_gu, w_down, routing)

