"""Optimal-transport (IPOT) distance of the cross-encoder's ITM loss
(counterpart of lightningdot_tpu/models/ot.py; reference
uniter_model/model/ot.py:8-83).

A masked cosine cost matrix, IPOT iterations, and the trace of C @ T as
the transport distance. The JAX ``fori_loop``s are Python loops with the
same trip counts. The plan T is computed without a gradient (JAX's
``stop_gradient``, the reference's ``@torch.no_grad``), so gradients flow
only through the cost matrix.
"""
from __future__ import annotations

import torch


def cost_matrix_cosine(x: torch.Tensor, y: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Batched pairwise cosine distance [B, Lx, D], [B, Ly, D] ->
    [B, Lx, Ly] (ot.py:14-20)."""
    xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)
    yn = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=eps)
    return 1.0 - torch.einsum("bld,bmd->blm", xn, yn)


@torch.no_grad()
def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta: float,
         iteration: int, k: int) -> torch.Tensor:
    """The transport plan [B, N, M] (ot.py:23-55). C [B, M, N]; the pads
    are bool (True = padded)."""
    b, m, n = C.shape
    jp_t = joint_pad.transpose(1, 2)
    sigma = torch.where(x_pad, torch.zeros((), dtype=C.dtype,
                                           device=C.device),
                        1.0 / x_len[:, None])                    # [B, M]
    T = torch.where(jp_t, 0.0, torch.ones((b, n, m), dtype=C.dtype,
                                          device=C.device))      # [B, N, M]
    A = torch.where(jp_t, 0.0, torch.exp(-C.transpose(1, 2) / beta))
    x_len_b = x_len[:, None, None]
    y_len_b = y_len[:, None, None]
    x_mask = (x_pad.to(C.dtype) * 1e4)[:, None, :]               # [B, 1, M]
    y_mask = (y_pad.to(C.dtype) * 1e4)[:, None, :]               # [B, 1, N]
    for _ in range(iteration):
        Q = A * T                                                # [B, N, M]
        delta = torch.zeros((b, 1, n), dtype=C.dtype, device=C.device)
        for _ in range(k):
            delta = 1.0 / (y_len_b * torch.einsum("bnm,bm->bn", Q, sigma
                                                  )[:, None, :] + y_mask)
            sigma = (1.0 / (x_len_b * torch.einsum("bon,bnm->bom", delta, Q)
                            + x_mask)).reshape(b, m)
        # T takes the delta of the last inner iteration (ot.py:59-61)
        T = delta.reshape(b, n, 1) * Q * sigma[:, None, :]
    return torch.where(jp_t, 0.0, T)


def optimal_transport_dist(txt_emb, img_emb, txt_pad, img_pad,
                           beta: float = 0.5, iteration: int = 50,
                           k: int = 1) -> torch.Tensor:
    """Per-example transport distance [B] (ot.py:58-73)."""
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(dim=1)).to(cost.dtype)
    img_len = (img_pad.shape[1] - img_pad.sum(dim=1)).to(cost.dtype)
    T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad,
             beta, iteration, k)
    # trace(C @ T)
    return torch.einsum("bmn,bnm->b", cost, T)
