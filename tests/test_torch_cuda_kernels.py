"""The port's CUDA kernels (K1 binned_scan, K2 merge_topc, K3 row_gather,
T3 shifted_scan, T4 gated_topm, T6 knn_topk) against their plain PyTorch
versions on the same card inputs, and the walks and indexes built on them
against the same on the CPU.

These need an NVIDIA GPU and nvcc, so they carry the ``cuda`` marker and skip
without a card. On a machine with one (which has no JAX), run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from gbnns_tpu_torch.kernels import distance_topk as dt
from gbnns_tpu_torch.kernels import gather
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


def _scan_kw(x, alpha, bin_size, packed):
    """``binned_scan``'s keywords for these operands: a prescaled corpus (an
    int8 one with its alpha), bin-major winners, one chunk."""
    kind = dict(quant=True) if alpha is not None else dict(prescaled=True)
    return dict(bin_size=bin_size, chunk=x.shape[0], packed=packed,
                transpose=False, **kind)


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
    cores = st.scan_cores(x.dtype, d, bin_size)
    assert cores == ("cuda" if bin_size == 8 else "tensor")
    on_route = st.launches_by_cores[f"binned_scan:{cores}"]
    kw = _scan_kw(x, alpha, bin_size, packed)
    got = st.binned_scan(q, x, add, alpha, **kw)
    torch.cuda.synchronize()
    assert st.launches["binned_scan"] == before + 1
    assert st.launches_by_cores[f"binned_scan:{cores}"] == on_route + 1
    ref = st.binned_scan_plain(q, x, add, alpha, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, rtol=1e-5, **kw)
    assert rep["ok"], rep
    if quant:  # exact integer dots and the same two roundings: bit-equal
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind,d", [("float32", 16), ("float32", 32),
                                    ("float32", 128), ("float32", 160),
                                    ("bfloat16", 160), ("bfloat16", 256),
                                    ("bfloat16", 208), ("int8", 160),
                                    ("int8", 256)])
@pytest.mark.parametrize("packed", [False, True])
def test_fp32_and_wide_scans_match_plain(dev, kind, d, packed):
    """The f32 kind, and widths above 128 (the wide kernel)."""
    n, B = 4096, 300
    q, x, add, alpha = (t.to(dev) if t is not None else None
                        for t in _scan_inputs(n, d, B, kind == "int8"))
    if kind == "float32":
        q, x = q.float(), x.float()
    add[-5:] = float("inf")
    kw = _scan_kw(x, alpha, 1024, packed)
    got = st.binned_scan(q, x, add, alpha, **kw)
    ref = st.binned_scan_plain(q, x, add, alpha, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, rtol=1e-5, **kw)
    assert rep["ok"], rep
    if kind == "int8":
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("packed", [False, True])
def test_fp16_scan_matches_plain(dev, d, packed):
    """K1's fp16 kind: exact products, fp32 sums."""
    n, B = 4096, 300
    q, x, add, _ = (t.to(dev) if t is not None else None
                    for t in _scan_inputs(n, d, B, False))
    q, x = q.to(torch.float16), x.to(torch.float16)
    add[-5:] = float("inf")
    before = st.launches["binned_scan"]
    kw = _scan_kw(x, None, 1024, packed)
    got = st.binned_scan(q, x, add, **kw)
    torch.cuda.synchronize()
    assert st.launches["binned_scan"] == before + 1
    ref = st.binned_scan_plain(q, x, add, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, rtol=1e-5, **kw)
    assert rep["ok"], rep


def test_binned_scan_kernel_odd_bin(dev):
    q, x, add, _ = (t.to(dev) if t is not None else None
                    for t in _scan_inputs(96 * 40, 32, 130, False, seed=3))
    kw = _scan_kw(x, None, 96, False)
    got = st.binned_scan(q, x, add, **kw)
    ref = st.binned_scan_plain(q, x, add, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, **kw)
    assert rep["ok"], rep


def _tensor_scan(q, x, add, alpha, bin_size, packed):
    """K1 on the tensor cores, with its launch counted on that route."""
    assert st.scan_cores(x.dtype, x.shape[1], bin_size) == "tensor"
    before = st.launches_by_cores["binned_scan:tensor"]
    got = st.binned_scan(q, x, add, alpha,
                         **_scan_kw(x, alpha, bin_size, packed))
    torch.cuda.synchronize()
    assert st.launches_by_cores["binned_scan:tensor"] == before + 1
    return got


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("bin_size", [16, 64, 1024])
@pytest.mark.parametrize("B", [1, 127, 1000])
@pytest.mark.parametrize("packed", [False, True])
def test_tensor_scan_matches_plain(dev, kind, bin_size, B, packed):
    """The tensor-core K1 at bins of one row tile up to the serving bin and
    batches that are not a multiple of its query tile; the last bin holds
    padding rows only: +inf and the bin's first row, as plain gives."""
    n = 4096
    q, x, add, alpha = (t.to(dev) if t is not None else None
                        for t in _scan_inputs(n, 32, B, kind == "int8"))
    if kind == "float16":
        q, x = q.to(torch.float16), x.to(torch.float16)
    add[-37:] = float("inf")
    add[n - bin_size:] = float("inf")
    got = _tensor_scan(q, x, add, alpha, bin_size, packed)
    kw = _scan_kw(x, alpha, bin_size, packed)
    ref = st.binned_scan_plain(q, x, add, alpha, **kw)
    assert got[0].shape == ref[0].shape == (n // bin_size, B)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, rtol=1e-5, **kw)
    assert rep["ok"], rep
    assert torch.isinf(got[0][-1]).all()
    assert (got[1][-1] == n - bin_size).all()
    if kind == "int8":  # exact integer dots, the same two roundings
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 960])
def test_tensor_scan_ties_go_to_the_lower_row(dev, kind, packed, d):
    """Eight distinct small-integer rows, each stored many times at
    shuffled positions: every sum is exact in both versions, so the
    kernel must give plain's values and, among tied copies, its lower
    row exactly."""
    rng = np.random.default_rng(d + packed)
    n, B, bin_size = 4096, 300, 256
    distinct = rng.integers(-3, 4, size=(8, d)).astype(np.float32)
    x = distinct[rng.integers(0, 8, n)]
    q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    add = torch.from_numpy((x ** 2).sum(-1).astype(np.float32)).to(dev)
    alpha = None
    if kind == "int8":
        qt, xt = (torch.from_numpy(a.astype(np.int8)) for a in (q, x))
        alpha = torch.full((B,), -2.0, device=dev)
    else:
        dt_ = getattr(torch, kind)
        qt, xt = torch.from_numpy(q).to(dt_), torch.from_numpy(-2 * x).to(dt_)
    qt, xt = qt.to(dev), xt.to(dev)
    got = _tensor_scan(qt, xt, add, alpha, bin_size, packed)
    ref = st.binned_scan_plain(qt, xt, add, alpha,
                               **_scan_kw(xt, alpha, bin_size, packed))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("packed", [False, True])
def test_scan_on_the_cuda_cores_when_asked(dev, kind, packed):
    """cores="cuda" runs the CUDA-core K1 at a shape the tensor cores would
    take (how chip_smoke.py times the route before the redesign); it
    agrees with plain as the default route does."""
    n, B, bin_size = 4096, 300, 1024
    q, x, add, alpha = (t.to(dev) if t is not None else None
                        for t in _scan_inputs(n, 32, B, kind == "int8"))
    if kind == "float16":
        q, x = q.to(torch.float16), x.to(torch.float16)
    before = st.launches_by_cores["binned_scan:cuda"]
    kw = _scan_kw(x, alpha, bin_size, packed)
    got = st.binned_scan(q, x, add, alpha, cores="cuda", **kw)
    torch.cuda.synchronize()
    assert st.launches_by_cores["binned_scan:cuda"] == before + 1
    ref = st.binned_scan_plain(q, x, add, alpha, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, rtol=1e-5, **kw)
    assert rep["ok"], rep


# T1's epilogues: (metric, prescaled, shifted); "angular" scores as ip
EPILOGUES = [("l2", False, False), ("ip", False, False),
             ("angular", False, False), ("l2", False, True),
             ("ip", False, True), ("l2", True, True)]


def _epilogue_inputs(n, d, B, kind, metric, prescaled, shifted, seed=0):
    """Operands of one epilogue: the corpus unscaled (or stored -2x / -x
    when prescaled), addvec the norms of the rows as stored in ``kind``
    (0 for ip), +inf on the last 37 rows; qshift the query's squared norm
    (l2) or the Pallas index's upper bound 1.02 |q| max|x| + 1 (ip)."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, kind)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 2.0
                         - 0.5).to(dt_)
    q = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dt_)
    xr, qr = x.float(), q.float()
    l2 = metric == "l2"
    add = (xr * xr).sum(-1) if l2 else torch.zeros(n)
    add[-37:] = float("inf")
    if prescaled:
        x = ((-2.0 if l2 else -1.0) * xr).to(dt_)        # exact
    qshift = None
    if shifted:
        qsq = (qr * qr).sum(-1)
        qshift = qsq if l2 else (1.02 * qsq.sqrt()
                                 * (xr * xr).sum(-1).sqrt().max() + 1.0)
    return q, x, add, qshift


def _epilogue_check(dev, kind, metric, prescaled, shifted, packed, cores,
                    d=32, n=4096, B=300, bin_size=1024):
    q, x, add, qshift = (None if t is None else t.to(dev) for t in
                         _epilogue_inputs(n, d, B, kind, metric, prescaled,
                                          shifted))
    kw = dict(metric=metric, bin_size=bin_size, chunk=n, packed=packed,
              prescaled=prescaled, transpose=False)
    before = st.launches_by_cores[f"binned_scan:{cores}"]
    got = st.binned_scan(q, x, add, qshift, cores=cores, **kw)
    torch.cuda.synchronize()
    assert st.launches_by_cores[f"binned_scan:{cores}"] == before + 1
    ref = st.binned_scan_plain(q, x, add, qshift, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, qshift, rtol=1e-5, **kw)
    assert rep["ok"], rep
    return got, ref


@pytest.mark.parametrize("kind,cores", [("bfloat16", "tensor"),
                                        ("bfloat16", "cuda"),
                                        ("float16", "tensor"),
                                        ("float16", "cuda"),
                                        ("float32", "cuda")])
@pytest.mark.parametrize("metric,prescaled,shifted", EPILOGUES)
@pytest.mark.parametrize("packed", [False, True])
def test_epilogues_match_plain(dev, kind, cores, metric, prescaled, shifted,
                               packed):
    """Every epilogue of T1 on both routes of K1 (f32 on the CUDA cores
    only), counted on its route, against the plain version."""
    got, ref = _epilogue_check(dev, kind, metric, prescaled, shifted, packed,
                               cores)
    if shifted and metric == "l2":   # scores are distances: >= ~0
        assert got[0][torch.isfinite(got[0])].min() > -1e-3


@pytest.mark.parametrize("d", [16, 64, 128, 160])
@pytest.mark.parametrize("metric,prescaled,shifted", [("l2", False, False),
                                                      ("l2", False, True)])
@pytest.mark.parametrize("packed", [False, True])
def test_epilogues_at_every_width(dev, d, metric, prescaled, shifted,
                                  packed):
    """The tensor-core widths on the routes scan_cores gives them: d = 160
    now takes the tensor cores too (both operands staged in shared
    memory), where it took the wide CUDA-core kernel."""
    cores = st.scan_cores(torch.bfloat16, d, 1024)
    assert cores == "tensor"
    _epilogue_check(dev, "bfloat16", metric, prescaled, shifted, packed,
                    cores, d=d)


# the wide tensor-core K1 (d > 128): T1's epilogues and the served
# prescaled ones, two of them (l2 and ip prescaled) beside EPILOGUES
WIDE_EPILOGUES = EPILOGUES + [("l2", True, False), ("ip", True, False)]


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [144, 160, 256, 272, 960])
@pytest.mark.parametrize("metric,prescaled,shifted", WIDE_EPILOGUES)
@pytest.mark.parametrize("packed", [False, True])
def test_wide_tensor_scan_epilogues_match_plain(dev, kind, d, metric,
                                                prescaled, shifted, packed):
    """K1 on the tensor cores above d = 128 (one stage of the ring at 144
    and 160 is partly zero-filled, 272 and 960 span several), every
    epilogue, counted on the tensor route."""
    assert st.scan_cores(kind, d, 1024) == "tensor"
    _epilogue_check(dev, kind, metric, prescaled, shifted, packed, "tensor",
                    d=d)


@pytest.mark.parametrize("d", [144, 160, 288, 304, 960])
@pytest.mark.parametrize("packed", [False, True])
def test_wide_tensor_int8_scan_is_bit_equal_to_plain(dev, d, packed):
    """int8 above d = 128: exact int32 sums converted per score (exact for
    |acc| < 2^24, where kMagic's convert stops at 2^22, d = 256), then the
    plain version's two roundings: bit-equal. At 144 and 304 (GloVe-300's
    scan_width) the row is 16 bytes past a multiple of 32, so the last
    k32 step is half zero-filled."""
    n, B = 4096, 300
    q, x, add, alpha = (t.to(dev) for t in _scan_inputs(n, d, B, True))
    add[-5:] = float("inf")
    got = _tensor_scan(q, x, add, alpha, 1024, packed)
    ref = st.binned_scan_plain(q, x, add, alpha,
                               **_scan_kw(x, alpha, 1024, packed))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("bin_size", [16, 64, 1024])
@pytest.mark.parametrize("B", [1, 300])
@pytest.mark.parametrize("packed", [False, True])
def test_wide_tensor_scan_bins_and_batches(dev, kind, bin_size, B, packed):
    """The wide tensor-core K1 at bins under its 128-row step and batches
    off its 256-query tile; the last bin holds padding rows only."""
    n = 4096
    q, x, add, alpha = (t.to(dev) if t is not None else None
                        for t in _scan_inputs(n, 160, B, kind == "int8"))
    add[n - bin_size:] = float("inf")
    got = _tensor_scan(q, x, add, alpha, bin_size, packed)
    kw = _scan_kw(x, alpha, bin_size, packed)
    ref = st.binned_scan_plain(q, x, add, alpha, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, alpha, rtol=1e-5, **kw)
    assert rep["ok"], rep
    assert torch.isinf(got[0][-1]).all()
    assert (got[1][-1] == n - bin_size).all()


@pytest.mark.parametrize("d", [24, 100, 200])
@pytest.mark.parametrize("kind", ["bfloat16", "float32"])
def test_scan_pads_a_width_no_kernel_takes(dev, d, kind):
    """binned_scan at a width JAX takes and no kernel does: padded with
    zero columns to scan_width(d) on the card, the plain version's winners
    at the unpadded width."""
    q, x, add, qshift = (None if t is None else t.to(dev) for t in
                         _epilogue_inputs(4096, d, 300, kind, "l2", False,
                                          False))
    kw = dict(bin_size=256, chunk=4096)
    got = st.binned_scan(q, x, add, **kw)
    ref = st.binned_scan_plain(q, x, add, **kw)
    rep = st.scan_agreement(got, ref, q, x, add, rtol=1e-5, **kw)
    assert rep["ok"], rep


@pytest.mark.parametrize("bin_size", [8, 16, 96])
@pytest.mark.parametrize("shifted", [False, True])
def test_epilogues_at_small_bins(dev, bin_size, shifted):
    """Bins of one row tile, and bins the tensor cores do not take."""
    packed = bin_size != 96
    _epilogue_check(dev, "bfloat16", "l2", False, shifted, packed,
                    st.scan_cores(torch.bfloat16, 32, bin_size),
                    n=96 * 64, bin_size=bin_size)


def test_jax_default_call_on_the_card(dev):
    """``binned_scan(q, x, add)`` as a JAX caller writes it: unprescaled
    l2, packed, query-major; f32 queries cast to the corpus type."""
    q, x, add, _ = (t.to(dev) if t is not None else None for t in
                    _epilogue_inputs(4096, 32, 300, "bfloat16", "l2", False,
                                     False))
    got = st.binned_scan(q.float(), x, add, bin_size=256, chunk=4096)
    ref = st.binned_scan_plain(q, x, add, bin_size=256, chunk=4096)
    assert got[0].shape == ref[0].shape == (300, 16)
    rep = st.scan_agreement(got, ref, q, x, add, bin_size=256, rtol=1e-5)
    assert rep["ok"], rep


@pytest.mark.parametrize("valid_b", [1, 250, 300])
def test_merge_topc_keeps_valid_columns(dev, valid_b):
    rng = np.random.default_rng(valid_b)
    vals = torch.from_numpy(rng.standard_normal((992, 300)).astype(
        np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 1 << 20, (992, 300)).astype(
        np.int32)).to(dev)
    gv, gi = st.merge_topc(vals, ids, 12, valid_b=valid_b)
    rv, ri = st.merge_topc_plain(vals, ids, 12)
    assert gv.shape == (valid_b, 12)
    assert torch.equal(gv, rv[:valid_b]) and torch.equal(gi, ri[:valid_b])


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
    assert st.launches["merge_topc"] == before + 1
    rv, ri = st.merge_topc_plain(vals, ids, c, rb=rb)
    assert torch.equal(gi, ri)
    assert torch.equal(gv, rv)


# (R, B, c, rb): the CPU order cases of test_torch_merge_order.py (ties,
# +inf rows, R not a multiple of rb, up to nine stages, fewer rows than ck)
# and the main path's shapes: serving bf16 c = 12 and int8 c = 16 over 992
# bins of 16,384 queries, the build's c = 33 over 8,192 nodes; B not a
# multiple of a block's 128 queries
MERGE_ORDER_CASES = [
    (37, 5, 12, 512), (977, 9, 12, 512), (992, 7, 16, 512),
    (992, 6, 33, 512), (5000, 4, 12, 32), (3001, 3, 16, 64),
    (20000, 3, 100, 512), (100000, 2, 12, 512), (100, 8, 12, 32),
    (14, 4, 12, 512), (992, 16384, 12, 512), (992, 16384, 16, 512),
    (992, 8192, 33, 512), (300, 1000, 12, 512), (2000, 333, 33, 512),
    (700, 130, 300, 1024),
]


@pytest.mark.parametrize("R,B,c,rb", MERGE_ORDER_CASES,
                         ids=["-".join(map(str, s)) for s in MERGE_ORDER_CASES])
def test_merge_topc_one_launch_equals_plain_with_ties(dev, R, B, c, rb):
    """One K2 launch a call, bit-equal to the staged plain merge on values
    with ties across blocks and splits and +inf rows."""
    rng = np.random.default_rng(R + c + rb)
    vals = np.round(rng.normal(size=(R, B)) * 8.0) / 8.0
    vals[rng.random((R, B)) < 0.05] = np.inf
    ids = rng.integers(0, 1 << 30, (R, B))
    vals = torch.from_numpy(vals.astype(np.float32)).to(dev)
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    before = st.launches["merge_topc"]
    gv, gi = st.merge_topc(vals, ids, c, rb=rb)
    torch.cuda.synchronize()
    assert st.launches["merge_topc"] == before + 1
    rv, ri = st.merge_topc_plain(vals, ids, c, rb=rb)
    assert torch.equal(gi, ri)
    assert torch.equal(gv.view(torch.int32), rv.view(torch.int32))


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


@pytest.mark.parametrize("scan_dtype,d_lo", [("float32", 24),
                                              ("bfloat16", 160)])
def test_fp32_and_wide_fused_index_card_matches_cpu(dev, scan_dtype, d_lo):
    rng = np.random.default_rng(6)
    base = rng.normal(size=(20000, 48)).astype(np.float32)
    query = rng.normal(size=(300, 48)).astype(np.float32)
    w = rng.normal(size=(48, d_lo)).astype(np.float32)
    kw = dict(scan_dtype=scan_dtype, chunk=1024)
    gpu = st.FusedScanIndex(base, base @ w, device="cuda", **kw)
    cpu = st.FusedScanIndex(base, base @ w, device="cpu", **kw)
    assert gpu.x_lo.shape[1] == max(32, d_lo)
    gi, gd = gpu.search(query, query @ w, k=10, c=32)
    ci, cd = cpu.search(query, query @ w, k=10, c=32, merge="pallas")
    assert (gi.cpu() == ci).all(dim=1).float().mean().item() >= 0.99
    np.testing.assert_allclose(gd.cpu().numpy(), cd.numpy(), rtol=1e-4,
                               atol=1e-4)


def _payload_rows(n, W, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64)
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32))


@pytest.mark.parametrize("R", [1, 31, 65536])
@pytest.mark.parametrize("W", [4, 544, 1056])
def test_row_gather_kernel_is_bit_exact(dev, R, W):
    n = 5000
    payload = _payload_rows(n, W).to(dev)  # NaN and inf patterns included
    rng = np.random.default_rng(R + W)
    idx = rng.integers(0, n, size=R).astype(np.int32)
    idx[0] = n - 1
    idx[-1] = 0
    idx = torch.from_numpy(idx).to(dev)
    before = gather.launches["row_gather"]
    got = gather.row_gather(payload, idx)
    torch.cuda.synchronize()
    assert gather.launches["row_gather"] == before + 1
    ref = gather.row_gather_plain(payload, idx)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_row_gather_kernel_rejects_bad_ids(dev):
    payload = _payload_rows(100, 32).to(dev)
    before = gather.launches["row_gather"]
    for bad in ([0, 100], [-1, 5]):
        with pytest.raises(IndexError):
            gather.row_gather(payload,
                              torch.tensor(bad, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        gather.row_gather(payload[:, :30].contiguous(),
                          torch.zeros(2, dtype=torch.int32, device=dev))
    assert gather.launches["row_gather"] == before
    # unchecked ids outside [0, n) read nothing and give zero rows
    out = gather.row_gather(payload, torch.tensor([100, 3], dtype=torch.int32,
                                                  device=dev), check_ids=False)
    torch.cuda.synchronize()
    assert not out[0].view(torch.int32).any()
    assert torch.equal(out[1].view(torch.int32), payload[3].view(torch.int32))


def _walk_inputs(n=20000, d=32, K=16, B=500, seed=7):
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 4
    base = (centers[rng.integers(0, 40, n)]
            + rng.normal(size=(n, d)).astype(np.float32))
    query = (centers[rng.integers(0, 40, B)]
             + rng.normal(size=(B, d)).astype(np.float32))
    graph = build_knn_graph(base, K, backend="fused", device="cuda")
    return base, query, graph


def test_payload_walker_on_the_card(dev):
    """K3 in the walk: the same walk as with the plain gather, the f32
    payload walk identical to the plain walker's, and the card's walk
    agreeing with the CPU's."""
    from gbnns_tpu_torch.search import walker, walker_payload as wp

    base, query, graph = _walk_inputs()
    entries = walker.default_entry_ids(base.shape[0], 16)
    q, b = torch.from_numpy(query).to(dev), torch.from_numpy(base).to(dev)
    for vec_dtype in ("bfloat16", "float32"):
        payload = wp.pack_hop_payload(graph, base, vec_dtype=vec_dtype,
                                      device=dev)
        before = gather.launches["row_gather"]
        got = wp.beam_search_payload(q, payload, b, entries, ef=48)
        assert gather.launches["row_gather"] - before == got.hops
        ref = wp.beam_search_payload(q, payload, b, entries, ef=48,
                                     gather=gather.row_gather_plain)
        for f in ("ids", "dists", "n_dist"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert got.hops == ref.hops
    plain = walker.beam_search(q, b, torch.from_numpy(graph).to(dev), entries,
                               ef=48)
    assert torch.equal(got.ids, plain.ids) and torch.equal(got.dists,
                                                           plain.dists)
    assert torch.equal(got.n_dist, plain.n_dist) and got.hops == plain.hops
    cpu = walker.beam_search(torch.from_numpy(query), torch.from_numpy(base),
                             torch.from_numpy(graph), entries, ef=48)
    assert (plain.ids.cpu() == cpu.ids).all(dim=1).float().mean() >= 0.98


def test_graph_index_on_the_card(dev):
    from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
    from gbnns_tpu_torch.search.graph_index import GraphIndex

    base, query, graph = _walk_inputs()
    idx = GraphIndex.build(base, K=16, graph=graph, ncent=64, device=dev)
    before = gather.launches["row_gather"]
    ids, dists = idx.search(query, k=10, ef=48)
    torch.cuda.synchronize()
    assert gather.launches["row_gather"] > before
    gt = exact_ground_truth(query, base, k=10, device=dev)
    assert recall_at_k(ids.cpu().numpy(), gt, 10) > 0.9
    assert torch.isfinite(dists).all()


def test_built_library_is_reused(dev):
    from gbnns_tpu_torch.kernels import _build

    st._library()
    st._gated_library()
    st._shifted_library()
    gather._library()
    dt._library()
    for name in ("scan_topk", "gated_topm", "gather", "shifted_scan",
                 "distance_topk"):
        path = _build.library_path(name)
        stamp = path.stat().st_mtime_ns
        _build.build([name])             # already built: no nvcc
        assert path.stat().st_mtime_ns == stamp
        assert path.parent.parent.name == ".kernel_build"


def _gated_inputs(n_pad, d, B, tq, chunk, dtype, mask, seed=0):
    """A prescaled corpus with padding rows, queries, and a tile mask:
    "all", "none" or "random" cells kept."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_pad, d)).astype(np.float32) * 2.0 - 0.5
    q = rng.normal(size=(B, d)).astype(np.float32)
    add = (x ** 2).sum(-1).astype(np.float32)
    add[-37:] = np.inf
    cells = (n_pad // chunk) * (B // tq)
    keep = {"all": np.ones(cells), "none": np.zeros(cells),
            "random": rng.random(cells) < 0.5}[mask]
    return (torch.from_numpy(q).to(dtype),
            torch.from_numpy(-2.0 * x).to(dtype), torch.from_numpy(add),
            torch.from_numpy(keep.astype(np.int32)))


# (n_pad, d, B, fine, m, sub, chunk, tq): the CPU tests' geometry (chunk /
# fine = 128 > sub, so km comes from chunk / fine), GatedScanIndex's
# defaults (km from sub), a tile of 64 queries (two tiles share a block),
# a 32-winner list and the other widths; each on the CUDA cores
GATED_SHAPES = [
    (4096, 32, 192, 4, 16, 64, 512, 64),
    (65536, 32, 1024, 32, 16, 1024, 16384, 512),
    (8192, 16, 384, 8, 32, 256, 2048, 128),
    (8192, 64, 256, 16, 8, 128, 1024, 256),
    (4096, 128, 256, 4, 16, 64, 512, 128),
]
# the tensor-core route: the index's geometry; fine 16 with a tile of one
# warp's 64 queries (the 8 warps of a block read 8 mask entries); m 32; B
# not a multiple of a block's 512 queries; d 16, 64 and 128 (n-tiles 8, 4
# and 2 a warp, blocks of 512, 256 and 128 queries), each with a partial
# last block; fine groups of two pipeline stages (fine 256 at d 32, 128 at
# d 64, 64 at d 128: the group's min carries across the ring); chunk /
# fine = 128 > sub = 64, so km comes from chunk / fine
GATED_TC_SHAPES = [
    (65536, 32, 1024, 32, 16, 1024, 16384, 512),
    (8192, 32, 512, 16, 16, 256, 2048, 64),
    (16384, 32, 512, 32, 32, 1024, 4096, 128),
    (8192, 32, 576, 32, 16, 512, 2048, 64),
    (8192, 16, 640, 16, 8, 128, 1024, 128),
    (8192, 64, 288, 32, 16, 256, 2048, 32),
    (4096, 128, 144, 16, 16, 64, 512, 16),
    (16384, 32, 512, 256, 16, 1024, 8192, 64),
    (8192, 64, 256, 128, 16, 1024, 4096, 32),
    (8192, 128, 128, 64, 16, 1024, 4096, 16),
    (4096, 32, 128, 16, 16, 64, 2048, 64),
]
_DTYPE_IDS = {torch.bfloat16: "bf16", torch.float16: "fp16",
              torch.float32: "f32"}
# the wide CUDA-core kernel: d 160 and 960 at the CPU tests' geometry and
# the index's defaults (two chunks), and 144 with a 32-winner list
GATED_WIDE_SHAPES = [
    (4096, 160, 192, 4, 16, 64, 512, 64),
    (32768, 960, 512, 32, 16, 1024, 16384, 512),
    (8192, 144, 384, 8, 32, 256, 2048, 128),
]
GATED_CASES = ([(s, dt, "cuda") for s in GATED_SHAPES + GATED_WIDE_SHAPES
                for dt in (torch.bfloat16, torch.float16, torch.float32)]
               + [(s, dt, "tensor") for s in GATED_TC_SHAPES
                  for dt in (torch.bfloat16, torch.float16)])


def _gated_scan(q, x, add, tile_mask, cores, **kw):
    """T4 on the route ``cores`` (the tensor cores only where
    ``gated_cores`` gives them), its launch counted on that route."""
    if cores == "tensor":
        assert st.gated_cores(x.dtype, x.shape[1], fine=kw["fine"],
                              tq=kw["tq"]) == "tensor"
    before = st.launches["gated_topm"]
    on_route = st.launches_by_cores[f"gated_topm:{cores}"]
    got = st.gated_topm_scan(q, x, add, tile_mask, cores=cores, **kw)
    torch.cuda.synchronize()
    assert st.launches["gated_topm"] == before + 1
    assert st.launches_by_cores[f"gated_topm:{cores}"] == on_route + 1
    return got


@pytest.mark.parametrize("shape,dtype,cores", GATED_CASES, ids=[
    "-".join(map(str, s)) + f"-{_DTYPE_IDS[dt]}-{c}"
    for s, dt, c in GATED_CASES])
@pytest.mark.parametrize("mask", ["all", "none", "random"])
def test_gated_topm_kernel_matches_plain(dev, shape, dtype, cores, mask):
    n_pad, d, B, fine, m, sub, chunk, tq = shape
    q, x, add, tile_mask = (t.to(dev) for t in _gated_inputs(
        n_pad, d, B, tq, chunk, dtype, mask))
    kw = dict(fine=fine, m=m, sub=sub, chunk=chunk, tq=tq)
    got = _gated_scan(q, x, add, tile_mask, cores, **kw)
    ref = st.gated_topm_scan_plain(q, x, add, tile_mask, **kw)
    assert got[0].shape == ref[0].shape == (B, m * (n_pad // chunk))
    rep = st.gated_agreement(got, ref, q, x, add, fine=fine, sub=sub,
                             chunk=chunk)
    assert rep["ok"], rep
    skipped = (ref[1] < 0)
    assert torch.equal(got[1] < 0, skipped)
    if mask == "none":
        assert skipped.all() and torch.isinf(got[0]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gated_tensor_scan_padding_chunk(dev, dtype):
    """The last chunk holds padding rows only (addvec +inf): its winners
    are +inf at the first row of each of the first m fine bins, as plain
    gives, and never beat a real row elsewhere."""
    n_pad, d, B, fine, m, sub, chunk, tq = 8192, 32, 512, 32, 16, 512, \
        2048, 128
    q, x, add, tile_mask = (t.to(dev) for t in _gated_inputs(
        n_pad, d, B, tq, chunk, dtype, "all", seed=4))
    add[-chunk:] = float("inf")
    kw = dict(fine=fine, m=m, sub=sub, chunk=chunk, tq=tq)
    got = _gated_scan(q, x, add, tile_mask, "tensor", **kw)
    ref = st.gated_topm_scan_plain(q, x, add, tile_mask, **kw)
    rep = st.gated_agreement(got, ref, q, x, add, fine=fine, sub=sub,
                             chunk=chunk)
    assert rep["ok"], rep
    last = slice((n_pad // chunk - 1) * m, None)
    assert torch.isinf(got[0][:, last]).all()
    assert torch.equal(got[1][:, last], ref[1][:, last])
    assert torch.isfinite(got[0][:, :last.start]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_gated_tensor_scan_ties_match_plain_exactly(dev, dtype, d):
    """Eight distinct small-integer rows, each stored many times at
    shuffled positions: every sum is exact in both versions, so the kernel
    must give plain's values and, among tied copies, its rows (the lower
    row in a fine group, the lower fine bin among groups) exactly."""
    rng = np.random.default_rng(d)
    n_pad, B, fine, m, sub, chunk = 8192, 256, 16, 16, 256, 2048
    tq = st.tc_warp_queries(d)
    distinct = rng.integers(-3, 4, size=(8, d)).astype(np.float32)
    x = distinct[rng.integers(0, 8, n_pad)]
    q = rng.integers(-3, 4, size=(B, d)).astype(np.float32)
    add = torch.from_numpy((x ** 2).sum(-1).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        (rng.random((n_pad // chunk) * (B // tq)) < 0.7).astype(np.int32))
    qt = torch.from_numpy(q).to(dtype).to(dev)
    xt = torch.from_numpy(-2 * x).to(dtype).to(dev)
    kw = dict(fine=fine, m=m, sub=sub, chunk=chunk, tq=tq)
    got = _gated_scan(qt, xt, add, keep.to(dev), "tensor", **kw)
    ref = st.gated_topm_scan_plain(qt, xt, add, keep.to(dev), **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_gated_warp_queries_match_the_kernel(dev):
    """``tc_warp_queries``, on which ``gated_cores`` decides, is the tq step
    the built tensor-core kernel takes (its ``TcShape::NT``)."""
    lib = st._gated_library()
    for d in st.SCAN_WIDTHS:
        assert lib.gbnns_gated_warp_queries(d) == st.tc_warp_queries(d)
    assert lib.gbnns_gated_warp_queries(24) == -1


def test_gated_topm_kernel_refuses_what_it_cannot_take(dev):
    q, x, add, tile_mask = (t.to(dev) for t in _gated_inputs(
        4096, 32, 128, 64, 512, torch.bfloat16, "all"))
    kw = dict(fine=4, sub=64, chunk=512, tq=64)
    before = st.launches["gated_topm"]
    with pytest.raises(ValueError, match="at most 32"):
        st.gated_topm_scan(q, x, add, tile_mask, m=64, **kw)
    with pytest.raises(TypeError, match="int8"):
        st.gated_topm_scan(q.to(torch.int8), x.to(torch.int8), add,
                           tile_mask, m=16, **kw)
    with pytest.raises(ValueError, match="pad B"):
        st.gated_topm_scan(q[:100], x, add, tile_mask, m=16, **kw)
    with pytest.raises(ValueError, match="tensor-core kernel"):  # fine 4
        st.gated_topm_scan(q, x, add, tile_mask, m=16, cores="tensor", **kw)
    with pytest.raises(ValueError, match="tensor-core kernel"):
        st.gated_topm_scan(q.float(), x.float(), add, tile_mask, m=16,
                           cores="tensor", **{**kw, "fine": 16})
    assert st.launches["gated_topm"] == before
    # d = 24, which it refused before, is padded to 32 and computed
    got = st.gated_topm_scan(q[:, :24], x[:, :24], add, tile_mask, m=16,
                             **kw)
    ref = st.gated_topm_scan_plain(q[:, :24], x[:, :24], add, tile_mask,
                                   m=16, **kw)
    rep = st.gated_agreement(got, ref, q[:, :24], x[:, :24], add, fine=4,
                             sub=64, chunk=512)
    assert rep["ok"], rep


def test_gated_index_on_the_card(dev, monkeypatch):
    """GatedScanIndex on the card: one T4 launch a search, on the tensor
    cores, answers as with the plain scan on the same index, recall as the
    CPU tests ask."""
    from gbnns_tpu_torch.eval.recall import exact_ground_truth, recall_at_k
    from gbnns_tpu_torch.search import gated
    from gbnns_tpu_torch.search.gated import GatedScanIndex

    rng = np.random.default_rng(9)
    centers = rng.normal(size=(64, 32)).astype(np.float32) * 3
    base = (centers[rng.integers(0, 64, 60000)]
            + rng.normal(size=(60000, 32)).astype(np.float32))
    query = (centers[rng.integers(0, 64, 1000)]
             + rng.normal(size=(1000, 32)).astype(np.float32))
    idx = GatedScanIndex(base, chunk=4096, sub=512, device=dev)
    gt = exact_ground_truth(query, base, k=10, device=dev)
    got = {}
    for probes in (4, 32):
        before = st.launches["gated_topm"]
        on_tc = st.launches_by_cores["gated_topm:tensor"]
        ids, dists, kept = idx.search(query, k=10, probes=probes,
                                      return_kept_frac=True)
        torch.cuda.synchronize()
        assert st.launches["gated_topm"] == before + 1
        assert st.launches_by_cores["gated_topm:tensor"] == on_tc + 1
        assert torch.isfinite(dists).all() and 0 < kept <= 1
        got[probes] = ids.cpu().numpy()
    assert recall_at_k(got[32], gt, 10) >= 0.93
    monkeypatch.setattr(gated, "gated_topm_scan", st.gated_topm_scan_plain)
    plain = idx.search(query, k=10, probes=4)[0].cpu().numpy()
    assert (plain == got[4]).all(axis=1).mean() >= 0.99


def _shifted_inputs(n_pad, n, d, B, metric, dtype, seed=0):
    """Augmented operands of a corpus of n rows padded to n_pad, at the
    kernel's width d + 4 (an ip corpus padded with zero columns)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, d), np.float32)
    x[:n] = rng.normal(size=(n, d)) * 2.0 - 0.5
    q = rng.normal(size=(B, d)).astype(np.float32)
    aug = st.augment_corpus(x, n, metric)
    aug = np.pad(aug, ((0, 0), (0, d + 4 - aug.shape[1])))
    max_norm = float(np.sqrt((x[:n] ** 2).sum(-1).max()))
    q_aug = st.augment_queries(torch.from_numpy(q), metric, max_norm)
    q_aug = torch.nn.functional.pad(q_aug, (0, d + 4 - q_aug.shape[1]))
    return q_aug, torch.from_numpy(aug).to(dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("bin_size", [8, 1024])
def test_shifted_scan_kernel_matches_plain(dev, d, metric, dtype, bin_size):
    q, x = (t.to(dev) for t in _shifted_inputs(8192, 8000, d, 300, metric,
                                               dtype))
    before = st.launches["shifted_scan"]
    cores = st.shifted_cores(x.dtype, d + 4, bin_size)
    assert cores == ("tensor" if bin_size == 1024 and dtype != torch.float32
                     else "cuda")
    on_route = st.launches_by_cores[f"shifted_scan:{cores}"]
    got = st.shifted_scan(q, x, bin_size=bin_size)
    torch.cuda.synchronize()
    assert st.launches["shifted_scan"] == before + 1
    assert st.launches_by_cores[f"shifted_scan:{cores}"] == on_route + 1
    ref = st.shifted_scan_plain(q, x, bin_size=bin_size)
    assert got[0].shape == ref[0].shape == (300, 8192 // bin_size)
    rep = st.shifted_agreement(got, ref, q, x, bin_size=bin_size)
    assert rep["ok"], rep
    # padding rows never win a bin that holds a real row; a bin of padding
    # rows only gives +inf
    real = -(-8000 // bin_size)
    assert (got[1][:, :real] < 8000).all()
    assert torch.isinf(got[0][:, real:]).all()


@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B", [1, 127, 1000])
def test_shifted_tensor_scan_matches_plain(dev, d, metric, dtype, B):
    """The tensor-core T3 at d_aug 20, 36, 68, 132 and 164 (the k8 tail at
    36, 68, 132 and 164), batches off its query tile, and a last bin of
    padding rows only (+inf, the bin's first row)."""
    n_pad, n, bin_size = 8192, 7000, 1024
    q, x = (t.to(dev) for t in _shifted_inputs(n_pad, n, d, B, metric,
                                               dtype))
    assert st.shifted_cores(x.dtype, d + 4, bin_size) == "tensor"
    before = st.launches_by_cores["shifted_scan:tensor"]
    got = st.shifted_scan(q, x, bin_size=bin_size)
    torch.cuda.synchronize()
    assert st.launches_by_cores["shifted_scan:tensor"] == before + 1
    ref = st.shifted_scan_plain(q, x, bin_size=bin_size)
    assert got[0].shape == ref[0].shape == (B, n_pad // bin_size)
    rep = st.shifted_agreement(got, ref, q, x, bin_size=bin_size)
    assert rep["ok"], rep
    assert torch.isinf(got[0][:, -1]).all()
    assert (got[1][:, -1] == n_pad - bin_size).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_shifted_scan_on_the_cuda_cores_when_asked(dev, dtype):
    """cores="cuda" runs the CUDA-core T3 at d_aug 36, where the tensor
    cores would run by default; it agrees with plain."""
    q, x = (t.to(dev) for t in _shifted_inputs(8192, 7000, 32, 300, "l2",
                                               dtype))
    before = st.launches_by_cores["shifted_scan:cuda"]
    got = st.shifted_scan(q, x, bin_size=1024, cores="cuda")
    torch.cuda.synchronize()
    assert st.launches_by_cores["shifted_scan:cuda"] == before + 1
    ref = st.shifted_scan_plain(q, x, bin_size=1024)
    rep = st.shifted_agreement(got, ref, q, x, bin_size=1024)
    assert rep["ok"], rep


@pytest.mark.parametrize("d", [272, 960])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("bin_size", [8, 1024])
@pytest.mark.parametrize("B", [127, 300])
def test_wide_shifted_scan_matches_plain(dev, d, metric, dtype, bin_size, B):
    """T3 past the register-resident widths: d_aug 276 and 964, which the
    wrapper pads to 280 and 968 (rows of a multiple of 16 bytes), on the
    tensor cores in bf16 and fp16 at bins of 1,024, and the wide CUDA-core
    kernel in f32 and at bins of 8; a last bin of padding rows only."""
    n_pad, n = 4096, 3500
    q, x = (t.to(dev) for t in _shifted_inputs(n_pad, n, d, B, metric,
                                               dtype))
    cores = st.shifted_cores(x.dtype, d + 4, bin_size)
    assert cores == ("tensor" if bin_size == 1024 and dtype != torch.float32
                     else "cuda")
    assert st.shifted_width(d + 4) == d + 8
    before = st.launches_by_cores[f"shifted_scan:{cores}"]
    got = st.shifted_scan(q, x, bin_size=bin_size)
    torch.cuda.synchronize()
    assert st.launches_by_cores[f"shifted_scan:{cores}"] == before + 1
    ref = st.shifted_scan_plain(q, x, bin_size=bin_size)
    rep = st.shifted_agreement(got, ref, q, x, bin_size=bin_size)
    assert rep["ok"], rep
    real = -(-n // bin_size)
    assert (got[1][:, :real] < n).all()
    assert torch.isinf(got[0][:, real:]).all()


@pytest.mark.parametrize("d", [960])
def test_wide_shifted_tensor_scan_ties_go_to_the_lower_row(dev, d):
    """Small-integer rows stored many times at d_aug 964: exact sums, so
    the wide T3 gives plain's keys exactly, ties to the lower row."""
    rng = np.random.default_rng(14)
    distinct = rng.integers(-3, 4, size=(8, d + 4)).astype(np.float32)
    x = torch.from_numpy(distinct[rng.integers(0, 8, 4096)])
    q = torch.from_numpy(rng.integers(-3, 4, size=(300, d + 4))
                         .astype(np.float32))
    x, q = x.to(dev, torch.bfloat16), q.to(dev, torch.bfloat16)
    got = st.shifted_scan(q, x, bin_size=256)
    ref = st.shifted_scan_plain(q, x, bin_size=256)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_shifted_tensor_scan_ties_go_to_the_lower_row(dev):
    """Small-integer rows stored many times: exact sums, so T3 gives
    plain's keys exactly, ties to the lower row."""
    rng = np.random.default_rng(13)
    distinct = rng.integers(-3, 4, size=(8, 36)).astype(np.float32)
    x = torch.from_numpy(distinct[rng.integers(0, 8, 4096)])
    q = torch.from_numpy(rng.integers(-3, 4, size=(300, 36))
                         .astype(np.float32))
    x, q = x.to(dev, torch.bfloat16), q.to(dev, torch.bfloat16)
    got = st.shifted_scan(q, x, bin_size=256)
    ref = st.shifted_scan_plain(q, x, bin_size=256)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_shifted_scan_kernel_refuses_what_it_cannot_take(dev):
    q, x = (t.to(dev) for t in _shifted_inputs(2048, 2048, 32, 64, "l2",
                                               torch.bfloat16))
    before = st.launches["shifted_scan"]
    with pytest.raises(TypeError, match="int8"):
        st.shifted_scan(q, x.to(torch.int8), bin_size=64)
    with pytest.raises(ValueError, match="power-of-two"):
        st.shifted_scan(q, x, bin_size=24)
    with pytest.raises(ValueError, match="augment mismatch"):
        st.shifted_scan(q[:, :20], x, bin_size=64)
    assert st.launches["shifted_scan"] == before
    # d_aug = 33, which it refused before, is padded to 36 and computed
    got = st.shifted_scan(q[:, :33], x[:, :33], bin_size=64)
    ref = st.shifted_scan_plain(q[:, :33], x[:, :33], bin_size=64)
    rep = st.shifted_agreement(got, ref, q[:, :33], x[:, :33], bin_size=64)
    assert rep["ok"], rep


@pytest.mark.parametrize("metric", ["l2", "angular"])
@pytest.mark.parametrize("scan_dtype", ["bfloat16", "float16", "float32"])
def test_shifted_index_card_matches_cpu(dev, metric, scan_dtype):
    rng = np.random.default_rng(7)
    base = rng.normal(size=(20000, 48)).astype(np.float32)
    query = rng.normal(size=(300, 48)).astype(np.float32)
    if metric == "angular":
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        query /= np.linalg.norm(query, axis=1, keepdims=True)
    kw = dict(metric=metric, scan_dtype=scan_dtype, chunk=1024,
              mode="shifted")
    gpu = st.FusedScanIndex(base, base[:, :24].copy(), device="cuda", **kw)
    cpu = st.FusedScanIndex(base, base[:, :24].copy(), device="cpu", **kw)
    assert gpu.x_aug.shape[1] == 36
    st.reset_launches()
    gi, gd = gpu.search(query, query[:, :24], k=10, c=32)
    torch.cuda.synchronize()
    assert st.launches["shifted_scan"] == 1
    assert st.launches["merge_topc"] == 0 and st.launches["binned_scan"] == 0
    ci, cd = cpu.search(query, query[:, :24], k=10, c=32)
    assert (gi.cpu() == ci).all(dim=1).float().mean().item() >= 0.99
    np.testing.assert_allclose(gd.cpu().numpy(), cd.numpy(), rtol=1e-4,
                               atol=1e-4)


# (nq, n, d, k): the CPU tests' shapes, the build's k = 33 at d = 32 with
# several corpus splits, and k = 128 at d = 128
KNN_SHAPES = [(100, 700, 32, 10), (64, 256, 16, 33), (80, 500, 24, 8),
              (10, 100, 8, 50), (3000, 40000, 32, 33), (500, 9000, 128, 128)]


@pytest.mark.parametrize("shape", KNN_SHAPES,
                         ids=["-".join(map(str, s)) for s in KNN_SHAPES])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_topk_kernel_matches_plain(dev, shape, metric, dtype):
    nq, n, d, k = shape
    rng = np.random.default_rng(nq + n)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q, x = q.to(dev, dtype), x.to(dev, dtype)
    before = dt.launches["knn_topk"]
    got = dt.knn_topk(q, x, k, metric=metric)
    torch.cuda.synchronize()
    assert dt.launches["knn_topk"] == before + 1
    ref = dt.knn_topk_plain(q, x, k, metric=metric)
    assert got[0].shape == got[1].shape == (nq, k)
    rep = dt.knn_agreement(got, ref, q, x, metric=metric)
    assert rep["ok"], rep
    assert (got[0].diff(dim=1) >= 0).all()
    assert ((got[1] >= 0) & (got[1] < n)).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_topk_kernel_ties_go_to_the_lower_id(dev, metric):
    """Rows stored four times at shuffled positions, across several corpus
    splits, and queries that are corpus rows: ids exactly the plain
    version's."""
    rng = np.random.default_rng(12)
    rows = rng.normal(size=(3000, 16)).astype(np.float32)
    x = np.tile(rows, (4, 1))[rng.permutation(12000)]
    q = np.concatenate([x[:200], rng.normal(size=(56, 16)).astype(np.float32)])
    q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    got = dt.knn_topk(q, x, 9, metric=metric)
    ref = dt.knn_topk_plain(q, x, 9, metric=metric)
    assert torch.equal(got[1], ref[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_knn_topk_padding_is_never_selected(dev):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1280, 8)).astype(np.float32))
    x[1000:] = q[0]
    got = dt.knn_topk(q.to(dev), x.to(dev), 50, n_valid=1000)
    ref = dt.knn_topk_plain(q, x, 50, n_valid=1000)
    assert (got[1] < 1000).all()
    assert dt.knn_agreement((got[0].cpu(), got[1].cpu()), ref, q, x)["ok"]


def test_knn_topk_kernel_refuses_what_it_cannot_take(dev):
    q = torch.zeros(16, 32, device=dev)
    x = torch.zeros(500, 32, device=dev)
    before = dt.launches["knn_topk"]
    with pytest.raises(ValueError, match="k <= 128"):
        dt.knn_topk(q, x, 129)
    with pytest.raises(ValueError, match="d <= 128"):
        dt.knn_topk(torch.zeros(16, 130, device=dev),
                    torch.zeros(500, 130, device=dev), 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dt.knn_topk(q.to(torch.int8), x.to(torch.int8), 5)
    with pytest.raises(ValueError, match="k=501 > n=500"):
        dt.knn_topk(q, x, 501)
    assert dt.launches["knn_topk"] == before


def _integer_knn_inputs(nq, n, d, seed):
    """Small-integer queries and rows, every corpus row stored twice: every
    product and sum is exact in any order, so distances tie often (the
    duplicates always) and the kernel must equal plain bit for bit."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-4, 5, size=(-(-n // 2), d)).astype(np.float32)
    x = np.concatenate([rows, rows])[:n][rng.permutation(n)]
    q = rng.integers(-4, 5, size=(nq, d)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(x)


@pytest.mark.parametrize("d", dt.KNN_WIDTHS)
@pytest.mark.parametrize("k", [1, 33, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_topk_kernel_is_exact_on_integer_inputs(dev, d, k, metric, dtype):
    """Every kernel width, k = 1, 33 and 128, nq and n not multiples of the
    kernel's 64-query and 256-row tiles, several corpus splits, duplicated
    rows: one launch, ids and distances equal to plain (max_abs_err 0)."""
    q, x = _integer_knn_inputs(130, 1037, d, seed=d + k)
    q, x = q.to(dev, dtype), x.to(dev, dtype)
    before = dt.launches["knn_topk"]
    got = dt.knn_topk(q, x, k, metric=metric)
    torch.cuda.synchronize()
    assert dt.launches["knn_topk"] == before + 1
    ref = dt.knn_topk_plain(q, x, k, metric=metric)
    rep = dt.knn_agreement(got, ref, q, x, metric=metric)
    assert rep["ok"] and rep["max_abs_err"] == 0.0, rep
    assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("k", [1, 33, 128])
def test_knn_topk_n_valid_on_integer_inputs(dev, k):
    """Rows past ``n_valid`` (copies of the queries, distance 0) are never
    selected; the rest equals plain exactly."""
    q, x = _integer_knn_inputs(70, 700, 32, seed=k)
    x = torch.cat([x, q[:60]])
    got = dt.knn_topk(q.to(dev), x.to(dev), k, n_valid=700)
    ref = dt.knn_topk_plain(q, x, k, n_valid=700)
    assert (got[1] < 700).all()
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[0].cpu(), ref[0])


@pytest.mark.parametrize("d", dt.KNN_WIDTHS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_topk_splits_of_several_tiles_on_integer_inputs(dev, d, metric):
    """2,100 queries (33 blocks) keep the splits few, so each split scans
    several 256-row tiles, and at d > 32 each tile in several ring stages:
    ids and distances equal to plain (max_abs_err 0)."""
    q, x = _integer_knn_inputs(2100, 5000, d, seed=d)
    got = dt.knn_topk(q.to(dev), x.to(dev), 33, metric=metric)
    ref = dt.knn_topk_plain(q, x, 33, metric=metric)
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[0].cpu(), ref[0])


@pytest.mark.parametrize("d", dt.KNN_WIDTHS)
def test_knn_blocks_per_sm_fits_every_width_and_k(dev, d):
    """The launch geometry keeps at least one block resident at every width
    and k, and two at the build's d = 32, k = 33."""
    lib = dt._library()
    for k in (1, 33, 128):
        blocks = dt._blocks_per_sm(lib, d, k)
        assert blocks >= 1, (d, k, blocks)
        if (d, k) == (32, 33):
            assert blocks == 2
