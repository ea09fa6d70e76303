"""Material-bank property fetch — the counterpart of
``physically_based_renderer_tpu/ops/fetch.py``.

``fetch_columns(table, mid)`` is ``table[clamp(mid, 0, M−1)]`` with a
backward of its own. The JAX package's one-hot MXU forward and backward are
TPU choices; what binds the port is the value and the gradient, summed per
material. Two things the card showed: an ``index_add_`` of every
pixel's cotangent into the (M, K) table put the background's run of id 0 on
one slot and serialised (3.33 of a 5.89 ms step), and float atomics change
a step's gradient bits from run to run. So the backward sums by blocks of
``FETCH_BLOCK`` pixels: one accumulating ``index_put_`` into (blocks·M, K)
partial rows (sorted; a run is at most one block long and is summed in
order), then a sum over the blocks (a fixed reduction order). The same bits
on every run, on the CPU and on the card.
"""

from __future__ import annotations

import torch

FETCH_BLOCK = 1024  # pixels whose cotangents one partial row sums


def index_sum(num_rows: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(num_rows, C) zeros plus each row of ``values`` (n, C) at its index
    in ``idx`` (n,), the same bits on every run: on the card an
    accumulating ``index_put_`` (it sorts the indices and sums each index's
    run in order: no float atomics); on the CPU ``index_add_`` (one pass in
    index order; the CPU ``index_put_`` adds from several threads)."""
    out = torch.zeros((num_rows, values.shape[-1]), dtype=values.dtype, device=values.device)
    if values.device.type == "cpu":
        return out.index_add_(0, idx, values)
    return out.index_put_((idx,), values, accumulate=True)


class _FetchColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, mid):
        ctx.save_for_backward(mid)
        ctx.num_rows = table.shape[0]
        return table[mid]

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (mid,) = ctx.saved_tensors
        m = ctx.num_rows
        k = g.shape[-1]
        gf = g.reshape(-1, k)
        n = gf.shape[0]
        blocks = max(1, -(-n // FETCH_BLOCK))
        keys = torch.arange(n, device=gf.device) // FETCH_BLOCK * m + mid.reshape(-1)
        return index_sum(blocks * m, keys, gf).reshape(blocks, m, k).sum(0), None


def fetch_columns(table: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """``table[mid]``: (M, K) table, integer ids of any shape → (..., K).
    Ids are clamped to [0, M) (the JAX package's rule, so a gather and a
    one-hot agree). Differentiable w.r.t. ``table``."""
    m = table.shape[0]
    return _FetchColumns.apply(table, mid.long().clamp(0, m - 1))
