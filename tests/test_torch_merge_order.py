"""K2's one-pass order on the CPU: the staged top-c merge (``merge_topc_plain``,
held against the JAX package's Pallas merge in test_torch_scan.py) equals
the top c of all rows in (quantized key, row) order, the quantized key being
the flipped IEEE score with its low log2(rb) bits cleared. The CUDA kernel
computes that order in one launch; test_torch_cuda_kernels.py holds it
against ``merge_topc_plain`` on the card at these cases.

Inputs come from numpy with a seed: values rounded to a few levels (ties
within and across stage blocks), +inf rows, R not a multiple of rb, and R
large enough for up to five stages."""

import numpy as np
import pytest
import torch

from gbnns_tpu_torch.kernels import scan_topk as st

# (R, B, c, rb): one stage; R not a multiple of rb; two to five stages;
# rb 32 / 64 / 512; c 12 / 16 / 33 / 100 (ck 16, 16, 40, 104); fewer rows
# than ck
ORDER_CASES = [
    (37, 5, 12, 512),
    (977, 9, 12, 512),
    (992, 7, 16, 512),
    (992, 6, 33, 512),
    (5000, 4, 12, 32),
    (3001, 3, 16, 64),
    (20000, 3, 100, 512),
    (100000, 2, 12, 512),
    (100, 8, 12, 32),
    (14, 4, 12, 512),
]


def order_inputs(R: int, B: int, seed: int):
    """Winners with ties (values on a coarse grid), +inf rows and ids that
    are not the rows; float32 values and int32 ids, both (R, B)."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.normal(size=(R, B)) * 8.0) / 8.0
    vals[rng.random((R, B)) < 0.05] = np.inf
    ids = rng.integers(0, 1 << 30, (R, B))
    return vals.astype(np.float32), ids.astype(np.int32)


def one_pass(vals: np.ndarray, ids: np.ndarray, c: int, rb: int):
    """The top c of all R rows by (quantized key, row), quantized values."""
    ck, rb, _ = st._merge_plan(c, rb, vals.shape[0])
    bits = vals.view(np.int32).astype(np.int64)
    flip = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = flip & ~np.int64(rb - 1)
    rows = np.arange(vals.shape[0], dtype=np.int64)[:, None]
    order = np.argsort((key << 32) | rows, axis=0, kind="stable")[:c]
    qkey = np.take_along_axis(key, order, axis=0)
    unflip = np.where(qkey < 0, qkey ^ 0x7FFFFFFF, qkey).astype(np.int32)
    out_v = unflip.view(np.float32).T
    out_i = np.take_along_axis(ids, order, axis=0).T
    return out_v, out_i


@pytest.mark.parametrize("R,B,c,rb", ORDER_CASES,
                         ids=["-".join(map(str, s)) for s in ORDER_CASES])
def test_staged_merge_is_the_one_pass_order(R, B, c, rb):
    vals, ids = order_inputs(R, B, seed=R + c + rb)
    ck, rb_used, fallback = st._merge_plan(c, rb, R)
    assert not fallback
    want_v, want_i = one_pass(vals, ids, c, rb)
    got_v, got_i = st.merge_topc_plain(torch.from_numpy(vals),
                                       torch.from_numpy(ids), c, rb=rb)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.view(np.int32))


def _stages(R: int, c: int, rb: int) -> int:
    ck, rb, _ = st._merge_plan(c, rb, R)
    stages, rows = 0, R
    while True:
        rows = ck * -(-rows // rb)
        stages += 1
        if rows == ck:
            return stages


def test_order_cases_span_one_to_five_stages():
    """The cases run the staged merge in one stage and in five or more."""
    stages = [_stages(R, c, rb) for R, _, c, rb in ORDER_CASES]
    assert min(stages) == 1 and max(stages) >= 5, stages
