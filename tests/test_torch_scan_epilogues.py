"""The port's ``binned_scan`` under the Pallas ``binned_scan``'s contract, held
against the JAX package's scan run as its own tests run it (interpret mode
on the CPU), on the same numpy-seeded inputs at the sizes of
tests/test_fused_scan.py: every epilogue of T1 (l2, ip and angular;
prescaled and not; with a per-query shift and without; packed and
unpacked), in bf16, fp16 and f32, query-major and bin-major, JAX's
no-keyword call, its all-negative ip case, and ``merge_topc(valid_b=)``.

Tolerances: ids equal, but for near-ties counted by ``scan_agreement``
(the port's score at its row lies within 1e-5 of the largest |value|, plus
one key quantum in packed mode, of JAX's bin minimum), at most two a call;
values within 5e-3 of the largest |value| of the call (one key quantum of
a packed bin of 128 is 2^-15 of it). The sums are fp32 in both packages,
in another order. The CUDA kernels are held against ``binned_scan_plain``
on the card (tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.kernels.scan_topk_pallas import binned_scan as jax_scan
from gbnns_tpu.kernels.scan_topk_pallas import merge_topc as jax_merge
from gbnns_tpu_torch.kernels import scan_topk as st

VALUE_TOL = 5e-3
MAX_NEAR_TIES = 2


def _inputs(n, d, B, kind, metric, prescaled, shift, seed, scale_x=2.0,
            shift_x=-0.5, scale_q=1.0):
    """numpy operands of one epilogue: the corpus rounded to ``kind`` (and
    stored -2x / -x when prescaled), addvec the norms of the rounded rows
    (0 for ip), +inf on the last 24 rows, and qshift the squared norm of
    the rounded query (l2) or the Pallas index's bound 1.02 |q| max|x| + 1
    (ip, angular)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * scale_x + shift_x).astype(np.float32)
    q = (rng.normal(size=(B, d)) * scale_q).astype(np.float32)
    dt = getattr(torch, kind)
    xr = torch.from_numpy(x).to(dt).float().numpy()
    qr = torch.from_numpy(q).to(dt).float().numpy()
    l2 = metric == "l2"
    add = ((xr * xr).sum(-1) if l2 else np.zeros(n)).astype(np.float32)
    add[-24:] = np.inf
    xs = ((-2.0 if l2 else -1.0) * xr if prescaled else xr).astype(np.float32)
    qshift = None
    if shift:
        qsq = (qr * qr).sum(-1)
        qshift = (qsq if l2 else 1.02 * np.sqrt(qsq)
                  * np.sqrt((xr * xr).sum(-1).max()) + 1.0).astype(np.float32)
    return q, xs, add, qshift


def _jax(q, xs, add, qshift, kind, **kw):
    return jax_scan(jnp.asarray(q), jnp.asarray(xs, dtype=getattr(jnp, kind)),
                    jnp.asarray(add),
                    None if qshift is None else jnp.asarray(qshift),
                    interpret=True, **kw)


def _port(q, xs, add, qshift, kind, **kw):
    dt = getattr(torch, kind)
    args = (torch.from_numpy(q), torch.from_numpy(xs).to(dt),
            torch.from_numpy(add),
            None if qshift is None else torch.from_numpy(qshift))
    return st.binned_scan(*args, **kw), args


def _hold(got, ref_np, args, **kw):
    """``got`` (the port's winners) against JAX's, as the docstring says."""
    B = args[0].shape[0]
    rv, ri = (np.asarray(a) for a in ref_np)
    if not kw.get("transpose", True):      # JAX pads its queries to tq
        rv, ri = rv[:, :B], ri[:, :B]
    ref = (torch.from_numpy(rv.copy()), torch.from_numpy(ri.copy()))
    assert got[0].shape == ref[0].shape and got[1].dtype == torch.int32
    kw = {k: v for k, v in kw.items() if k not in ("tq", "cores")}
    rep = st.scan_agreement(got, ref, *args, rtol=1e-5, **kw)
    assert rep["ok"], rep
    assert rep["id_mismatches"] <= MAX_NEAR_TIES, rep
    finite = rv[np.isfinite(rv)]
    scale = float(np.abs(finite).max()) if finite.size else 1.0
    assert rep["max_abs_err"] <= VALUE_TOL * scale, rep
    return rep


# (metric, prescaled, shift, packed, kind, transpose): every epilogue, each
# kind and both layouts at least once
CASES = [
    ("l2", False, False, True, "bfloat16", True),
    ("l2", False, False, False, "bfloat16", False),
    ("ip", False, False, True, "float16", True),
    ("angular", False, False, False, "float32", True),
    ("l2", False, True, True, "bfloat16", True),
    ("l2", False, True, False, "float16", False),
    ("ip", False, True, True, "float32", True),
    ("angular", False, True, False, "bfloat16", True),
    ("l2", True, True, True, "bfloat16", False),
    ("ip", True, True, False, "float16", True),
    ("l2", True, False, True, "float32", True),
]


@pytest.mark.parametrize("metric,prescaled,shift,packed,kind,transpose",
                         CASES)
def test_epilogue_matches_pallas(metric, prescaled, shift, packed, kind,
                                 transpose):
    seed = len(metric) + 2 * prescaled + 4 * shift + 8 * packed
    q, xs, add, qshift = _inputs(1024, 32, 48, kind, metric, prescaled,
                                 shift, seed)
    kw = dict(metric=metric, bin_size=128, chunk=512, tq=64, packed=packed,
              prescaled=prescaled, transpose=transpose)
    ref = _jax(q, xs, add, qshift, kind, **kw)
    got, args = _port(q, xs, add, qshift, kind, **kw)
    n_bins = 1024 // 128
    assert got[0].shape == ((48, n_bins) if transpose else (n_bins, 48))
    _hold(got, ref, args, **kw)
    if shift and metric == "l2":   # shifted scores are distances: >= ~0
        assert float(got[0][torch.isfinite(got[0])].min()) > -1e-2


@pytest.mark.parametrize("packed", [False, True])
def test_all_negative_ip(packed):
    """tests/test_fused_scan.py:61's case: ip with every score far below 0,
    which the packed key's sign flip must order."""
    q, xs, add, _ = _inputs(512, 32, 32, "bfloat16", "ip", False, False,
                            seed=9, scale_x=10.0, shift_x=0.0, scale_q=10.0)
    add[:] = 0.0
    kw = dict(metric="ip", bin_size=64, chunk=256, tq=32, packed=packed)
    ref = _jax(q, xs, add, None, "bfloat16", **kw)
    got, args = _port(q, xs, add, None, "bfloat16", **kw)
    _hold(got, ref, args, **kw)
    assert float(got[0].max()) < 0


def test_jax_call_without_keywords():
    """``binned_scan(q, x, add)``: unprescaled l2, bins of 1,024 in chunks
    of 16,384, packed, query-major; f32 queries cast to the bf16 corpus.
    (The Pallas call needs ``interpret=True`` on the CPU, and only that.)"""
    q, xs, add, _ = _inputs(16384, 32, 40, "bfloat16", "l2", False, False,
                            seed=4)
    ref = jax_scan(jnp.asarray(q), jnp.asarray(xs, dtype=jnp.bfloat16),
                   jnp.asarray(add), interpret=True)
    got, args = _port(q, xs, add, None, "bfloat16")
    assert got[0].shape == (40, 16)
    _hold(got, ref, args)


def test_merge_topc_keeps_valid_queries():
    """JAX's bin-major winners (queries padded to its tile) through both
    merges with ``valid_b``: equal, bit for bit."""
    q, xs, add, _ = _inputs(2048, 32, 40, "bfloat16", "l2", False, False,
                            seed=5)
    raw_v, raw_i = _jax(q, xs, add, None, "bfloat16", bin_size=64,
                        chunk=512, tq=32, packed=False, transpose=False)
    assert raw_v.shape == (32, 64)
    jv, ji = jax_merge(raw_v, raw_i, 10, valid_b=40, tq=32, interpret=True)
    vals = torch.from_numpy(np.asarray(raw_v).copy())
    ids = torch.from_numpy(np.asarray(raw_i).copy())
    mv, mi = st.merge_topc(vals, ids, 10, valid_b=40, tq=32, interpret=True)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))


def test_shift_drops_the_flip():
    """With a shift the packed key is the raw bits: a negative residue
    sorts by its raw int (after every non-negative score of an ordinary
    bin), as in the Pallas kernel; without one the flip orders it first."""
    x = torch.tensor([[1.0, 0.0], [0.0, 0.0], [2.0, 0.0], [0.0, 0.0]])
    add = torch.tensor([0.0, -1e-3, 0.0, -2e-3])
    q = torch.tensor([[0.0, 0.0]])
    kw = dict(bin_size=4, chunk=4, prescaled=True, transpose=False)
    v, i = st.binned_scan(q, x, add, torch.zeros(1), **kw)
    flip_v, flip_i = st.binned_scan(q, x, add, **kw)
    assert int(flip_i[0, 0]) == 3                    # -2e-3: the minimum
    assert int(i[0, 0]) == 1        # raw bits: -1e-3 is the smaller int
    assert float(v[0, 0]) < 0


def test_scan_refuses_what_jax_refuses():
    q, xs, add, _ = _inputs(512, 32, 8, "bfloat16", "l2", False, False, 1)
    args = (torch.from_numpy(q), torch.from_numpy(xs).to(torch.bfloat16),
            torch.from_numpy(add))
    with pytest.raises(ValueError, match="chunk"):
        st.binned_scan(*args, bin_size=128, chunk=384)
    with pytest.raises(ValueError, match="power-of-two"):
        st.binned_scan(args[0], args[1][:384], args[2][:384], bin_size=96,
                       chunk=384)
    with pytest.raises(ValueError, match="quant=True needs int8"):
        st.binned_scan(*args, torch.ones(8), bin_size=128, chunk=512,
                       quant=True)
    with pytest.raises(ValueError, match="qshift has shape"):
        st.binned_scan(*args, torch.ones(7), bin_size=128, chunk=512)
