"""bfloat16 rounding as the JAX package's ``--bf16`` path rounds on XLA's
CPU backend, for the plain versions of the kernels.

Two rules, found by running the JAX package's ops on the CPU:

* an elementwise bfloat16 op (an add, a product, a conversion from
  float32) is computed in float32 and rounded to bfloat16, to nearest
  even, once per op;
* a bfloat16 scatter-add (the transpose of a gather, as in the backward
  of K1's and K2's scans) rounds its updates to bfloat16, then adds them
  one at a time in update order, rounding the running sum to bfloat16
  after each add. PyTorch's own ``index_add_`` on bfloat16 sums in
  float32 and rounds once, so it is not this scatter.
"""

from __future__ import annotations

import torch


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def scatter_add_bf16(n_rows: int, index: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """The bfloat16 scatter-add into zeros (``n_rows``, C): the rows of
    ``values`` (K, C) float32, rounded to bfloat16, added to row
    ``index[k]`` (K,) in the order k = 0 .. K - 1, each sum rounded to
    bfloat16. Returns (n_rows, C) float32 holding bfloat16 values.

    Vectorized by rank: the k-th update of every row is added in round k,
    so the rounds number the most updates any row takes."""
    out = torch.zeros((n_rows, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    k = index.shape[0]
    if k == 0:
        return out
    vals = bf16_round(values)
    rows, perm = torch.sort(index.long(), stable=True)
    pos = torch.arange(k, device=index.device)
    start = torch.ones(k, dtype=torch.bool, device=index.device)
    start[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        at = rows[sel]
        out[at] = bf16_round(out[at] + vals[perm[sel]])
    return out
