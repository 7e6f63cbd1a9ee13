"""The plain versions of the port's kernels against the JAX package's Pallas
kernels, run as its own tests run them (interpret mode on the CPU):
``binned_scan_plain`` vs ``binned_scan`` and ``merge_topc_plain`` vs
``merge_topc``. The CUDA kernels are held against these plain versions on
the card (test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnns_tpu.kernels.scan_topk_pallas import binned_scan as jax_scan
from gbnns_tpu.kernels.scan_topk_pallas import merge_topc as jax_merge
from gbnns_tpu_torch.kernels import scan_topk as st

N, D, B, BIN = 1024, 32, 48, 128


def _inputs(quant, metric, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, D)) * 2.0 - 0.5).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    scale = -2.0 if metric == "l2" else -1.0
    if quant:
        sx = 127.0 / np.abs(x).max()
        xi = np.clip(np.rint(x * sx), -127, 127).astype(np.int8)
        sq = 127.0 / np.abs(q).max(axis=1)
        qi = np.clip(np.rint(q * sq[:, None]), -127, 127).astype(np.int8)
        add = (((xi / sx) ** 2).sum(-1) if metric == "l2"
               else np.zeros(N)).astype(np.float32)
        alpha = (scale / (sx * sq)).astype(np.float32)
        jax_args = (jnp.asarray(qi), jnp.asarray(xi), jnp.asarray(add),
                    jnp.asarray(alpha))
        mine = (torch.from_numpy(qi), torch.from_numpy(xi),
                torch.from_numpy(add), torch.from_numpy(alpha))
        return jax_args, dict(quant=True), mine
    add = ((x ** 2).sum(-1) if metric == "l2" else np.zeros(N)).astype(
        np.float32)
    add[-40:] = np.inf                    # padding rows
    xb = jnp.asarray(scale * x, dtype=jnp.bfloat16)
    jax_args = (jnp.asarray(q), xb, jnp.asarray(add))
    mine = (torch.from_numpy(q).to(torch.bfloat16),
            torch.from_numpy(scale * x).to(torch.bfloat16),
            torch.from_numpy(add), None)
    return jax_args, dict(prescaled=True), mine


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_binned_scan_plain_matches_pallas(quant, packed, metric):
    jax_args, kw, mine = _inputs(quant, metric, seed=int(quant) + 2 * packed)
    jv, ji = jax_scan(*jax_args, metric=metric, bin_size=BIN, chunk=512,
                      tq=64, interpret=True, packed=packed, transpose=False,
                      **kw)
    ref = (torch.from_numpy(np.asarray(jv)[:, :B].copy()),
           torch.from_numpy(np.asarray(ji)[:, :B].copy()))
    got = st.binned_scan_plain(*mine, bin_size=BIN, packed=packed)
    assert got[0].shape == (N // BIN, B) and got[1].dtype == torch.int32
    # same inputs; fp32 sums in another order: ids equal except near-ties
    rep = st.scan_agreement(got, ref, *mine, bin_size=BIN, packed=packed,
                            rtol=1e-5)
    assert rep["ok"], rep
    assert rep["id_mismatches"] <= 2


def test_binned_scan_routes_cpu_tensors_to_plain():
    _, _, mine = _inputs(False, "l2", seed=5)
    before = dict(st.launches)
    got = st.binned_scan(*mine, bin_size=BIN)
    ref = st.binned_scan_plain(*mine, bin_size=BIN)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert st.launches == before          # nothing launched on the CPU


def test_binned_scan_validates_inputs():
    _, _, (q, x, add, _) = _inputs(False, "l2", seed=6)
    with pytest.raises(TypeError):
        st.binned_scan(q.float(), x, add, bin_size=BIN)
    with pytest.raises(ValueError):
        st.binned_scan(q, x[:1000], add[:1000], bin_size=BIN)
    with pytest.raises(ValueError):
        st.binned_scan(q, x, add, bin_size=96, packed=True)
    with pytest.raises(ValueError):
        st.binned_scan(q, x, add, torch.ones(B), bin_size=BIN)


def _winners(R, Bq, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((R, Bq)).astype(np.float32)
    vals[rng.random((R, Bq)) < 0.05] = np.inf
    vals[::7, 0] = vals[0, 0]                  # exact ties across rows
    ids = rng.integers(0, 1 << 20, size=(R, Bq)).astype(np.int32)
    return vals, ids


@pytest.mark.parametrize("R,Bq,c,rb", [
    (300, 24, 10, 512),    # one stage
    (1100, 16, 12, 512),   # two stages
    (100, 8, 9, 16),       # ck=16 raises rb from 16 to 32, four stages
    (20, 8, 20, 512),      # c >= rows: exact fallback
    (2100, 4, 1100, 512),  # rb would pass 2048: exact fallback
])
def test_merge_topc_plain_equals_pallas(R, Bq, c, rb):
    vals, ids = _winners(R, Bq, seed=R + c)
    jv, ji = jax_merge(jnp.asarray(vals), jnp.asarray(ids), c, valid_b=Bq,
                       rb=rb, tq=8 if Bq % 8 == 0 else Bq, interpret=True)
    mv, mi = st.merge_topc_plain(torch.from_numpy(vals),
                                 torch.from_numpy(ids), c, rb=rb)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))


def test_merge_topc_plain_pads_short_pools():
    vals, ids = _winners(5, 3, seed=1)
    v, i = st.merge_topc_plain(torch.from_numpy(vals), torch.from_numpy(ids),
                               3, rb=8)
    order = np.argsort(vals, axis=0, kind="stable")[:3].T
    np.testing.assert_array_equal(i.numpy(),
                                  np.take_along_axis(ids.T, order, axis=1))
