"""The segment sum that assembles the back end's and bundle adjustment's
normal equations, with one summation order on every device.

`segment_sum(x, idx, n)` adds the rows of x into n destinations: each
destination's rows are added one at a time in row order, starting from
zero.  That is the order of `index_add_` on the CPU and of XLA's scatter
there.  On the card `index_add_` adds with atomics, in an order that
changes from run to run; there `index_put_(..., accumulate=True)` sorts
the destinations with a stable radix sort and walks each destination's
run of rows in that order, so a sum is the CPU's, bit for bit, and the
same in every run.  No process-wide switch
(`torch.use_deterministic_algorithms`) is touched.

That order is how torch implements `index_put_(accumulate=True)` on
CUDA, which torch does not document: the stable sort; a kernel that,
for rows of 2 to 36 values, adds each destination's run one row at a
time; and, for rows of one value, a kernel that adds by a tree (hence
the zero column below).  It was checked on torch 2.11.0+cu128 (CUDA
12.8, NVIDIA H100 80GB HBM3).  On another torch build, run the card
tests `tests/test_torch_cuda.py::test_segment_sum_card_equals_cpu` and
`test_backends_repeat_bit_for_bit` (and chip_smoke.py, which runs the
back end and global BA twice) before relying on it.

Callers that add several groups of rows into one destination array pass
them concatenated in one call, so each destination starts from zero and
sums its rows in (group, row) order, as successive `index_add_` calls
on the CPU do.
"""

from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *x.shape[1:]) sums of the rows x[e] into row idx[e], each row's
    terms added in the order of e from zero, on x's device."""
    if x.shape[1:].numel() == 1:
        # a row of one value would take index_put_'s kernel for single
        # values, which adds long runs by a tree: give each a zero beside
        flat = x.reshape(-1)
        return segment_sum(torch.stack([flat, torch.zeros_like(flat)], 1),
                           idx, n)[:, 0].reshape((n,) + tuple(x.shape[1:]))
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.is_cuda:
        if x.shape[1:].numel() > 36:
            raise ValueError(f"segment_sum: rows of {x.shape[1:].numel()} "
                             f"values are not summed in order on the card "
                             f"(at most 36)")
        return out.index_put_((idx,), x, accumulate=True)
    return out.index_add_(0, idx, x)
