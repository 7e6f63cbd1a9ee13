"""The port's CUDA kernels (K1 binned_scan, K2 merge_topc) against their plain
PyTorch versions on the same card inputs.

These need an NVIDIA GPU and nvcc, so they carry the ``cuda`` marker and skip
without a card. On a machine with one (which has no JAX), run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from gbnns_tpu_torch.kernels import scan_topk as st

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scan_inputs(n, d, B, quant, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * 2.0 - 0.5
    q = rng.normal(size=(B, d)).astype(np.float32)
    if quant:
        x8 = np.clip(np.rint(x * 20.0), -127, 127).astype(np.int8)
        q8 = np.clip(np.rint(q * 40.0), -127, 127).astype(np.int8)
        add = ((x8.astype(np.float32) / 20.0) ** 2).sum(-1)
        alpha = (-2.0 / (20.0 * 40.0 * (1.0 + rng.random(B)))).astype(np.float32)
        return (torch.from_numpy(q8), torch.from_numpy(x8),
                torch.from_numpy(add.astype(np.float32)),
                torch.from_numpy(alpha))
    add = (x ** 2).sum(-1).astype(np.float32)
    return (torch.from_numpy(q).to(torch.bfloat16),
            torch.from_numpy(-2.0 * x).to(torch.bfloat16),
            torch.from_numpy(add), None)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bin_size", [8, 1024])
def test_binned_scan_kernel_matches_plain(dev, d, quant, packed, bin_size):
    n, B = 8192, 700          # B not a multiple of the query tile
    q, x, add, alpha = (t.to(dev) if t is not None else None
                        for t in _scan_inputs(n, d, B, quant))
    add[-37:] = float("inf")  # padding rows never win
    before = st.launches["binned_scan"]
    got = st.binned_scan(q, x, add, alpha, bin_size=bin_size, packed=packed)
    torch.cuda.synchronize()
    assert st.launches["binned_scan"] == before + 1
    ref = st.binned_scan_plain(q, x, add, alpha, bin_size=bin_size,
                               packed=packed)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, bin_size=bin_size,
                            packed=packed, rtol=1e-5)
    assert rep["ok"], rep
    if quant:  # exact integer dots and the same two roundings: bit-equal
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_binned_scan_kernel_odd_bin(dev):
    q, x, add, _ = (t.to(dev) if t is not None else None
                    for t in _scan_inputs(96 * 40, 32, 130, False, seed=3))
    got = st.binned_scan(q, x, add, bin_size=96)
    ref = st.binned_scan_plain(q, x, add, bin_size=96)
    rep = st.scan_agreement(got, ref, q, x, add, bin_size=96, packed=False)
    assert rep["ok"], rep


@pytest.mark.parametrize("R,B,c,rb", [
    (977, 300, 12, 512),     # the serving shape's bin count, two stages
    (977, 300, 16, 512),
    (5000, 40, 10, 512),     # three stages
    (700, 33, 300, 512),     # rb raised to 1024
    (100, 17, 5, 16),        # small blocks, many stages
    (64, 9, 3, 512),         # one padded block
])
def test_merge_topc_kernel_equals_plain(dev, R, B, c, rb):
    rng = np.random.default_rng(R + c)
    vals = torch.from_numpy(rng.standard_normal((R, B)).astype(np.float32))
    vals[rng.random((R, B)) < 0.05] = float("inf")
    ids = torch.from_numpy(rng.integers(0, 1 << 20, (R, B)).astype(np.int32))
    vals, ids = vals.to(dev), ids.to(dev)
    before = st.launches["merge_topc"]
    gv, gi = st.merge_topc(vals, ids, c, rb=rb)
    torch.cuda.synchronize()
    assert st.launches["merge_topc"] > before
    rv, ri = st.merge_topc_plain(vals, ids, c, rb=rb)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


def test_merge_topc_fallback_launches_nothing(dev):
    vals = torch.randn(40, 8, device=dev)
    ids = torch.arange(320, device=dev, dtype=torch.int32).view(40, 8)
    before = st.launches["merge_topc"]
    v, i = st.merge_topc(vals, ids, 40)  # c >= rows: exact sort
    assert st.launches["merge_topc"] == before
    rv, ri = st.merge_topc_plain(vals, ids, 40)
    assert torch.equal(i, ri) and torch.equal(v, rv)


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
def test_fused_index_card_matches_cpu(dev, scan_dtype):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(20000, 48)).astype(np.float32)
    base_lo = base[:, :24].copy()
    query = rng.normal(size=(300, 48)).astype(np.float32)
    kw = dict(scan_dtype=scan_dtype, chunk=1024)
    gpu = st.FusedScanIndex(base, base_lo, device="cuda", **kw)
    cpu = st.FusedScanIndex(base, base_lo, device="cpu", **kw)
    gi, gd = gpu.search(query, query[:, :24], k=10, c=32)
    ci, cd = cpu.search(query, query[:, :24], k=10, c=32, merge="pallas")
    agree = (gi.cpu() == ci).all(dim=1).float().mean().item()
    assert agree >= 0.99
    np.testing.assert_allclose(gd.cpu().numpy(), cd.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_built_library_is_reused(dev):
    from gbnns_tpu_torch.kernels import _build

    st._library()
    path = _build.library_path("scan_topk")
    stamp = path.stat().st_mtime_ns
    _build.build(["scan_topk"])          # already built: no nvcc
    assert path.stat().st_mtime_ns == stamp
    assert path.parent.parent.name == ".kernel_build"
