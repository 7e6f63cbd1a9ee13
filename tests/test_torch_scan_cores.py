"""Which cores K1 (binned_scan), T3 (shifted_scan) and T4 (gated_topm_scan)
run on: the route functions ``scan_cores``, ``shifted_cores`` and
``gated_cores`` give "tensor" for every shape of the main paths (the served
bf16/fp16/int8 scans, the graph build's packed scan, the shifted search,
the gated search at GatedScanIndex's defaults) and "cuda" for f32 and for
shapes the tensor-core kernels do not tile; T3 pads a width no kernel
takes to ``shifted_width``. The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py)."""

import inspect

import numpy as np
import pytest
import torch

from gbnns_tpu_torch.build.knn_graph import fused_operands
from gbnns_tpu_torch.kernels import scan_topk as st

N_MAIN = 140_000      # large enough for the 1,024-row bins of the main paths


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(N_MAIN, 32)).astype(np.float32)
    return base


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("packed", [False, True])
def test_served_scans_take_the_tensor_cores(corpus, kind, packed):
    idx = st.FusedScanIndex(corpus, scan_dtype=kind, packed=packed,
                            device="cpu")
    assert idx.bin_size == 1024 and idx.x_lo.shape[1] == 32
    assert st.scan_cores(idx.x_lo.dtype, idx.x_lo.shape[1],
                         idx.bin_size) == "tensor"
    assert st.scan_cores(kind, 32, 1024) == "tensor"


def test_graph_build_scan_takes_the_tensor_cores(corpus):
    _, x, _, bin_size = fused_operands(corpus, 32, device="cpu")
    assert bin_size == 1024 and x.dtype == torch.bfloat16
    assert st.scan_cores(x.dtype, x.shape[1], bin_size) == "tensor"


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_shifted_search_takes_the_tensor_cores(corpus, kind, metric):
    idx = st.FusedScanIndex(corpus, scan_dtype=kind, metric=metric,
                            mode="shifted", device="cpu")
    d_aug = idx.x_aug.shape[1]
    assert d_aug == 36 and idx.bin_size == 1024
    assert st.shifted_cores(idx.x_aug.dtype, d_aug, idx.bin_size) == "tensor"
    assert st.shifted_cores(kind, 36) == "tensor"
    assert st.shifted_width(d_aug) == d_aug   # stored at the kernel's width


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("bin_size", [16, 64, 96, 1024])
def test_tensor_route_widths_and_bins(kind, d, bin_size):
    assert st.scan_cores(kind, d, bin_size) == "tensor"
    assert st.scan_cores(getattr(torch, kind), d, bin_size) == "tensor"


@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("bin_size", [8, 1024])
def test_f32_scans_stay_on_the_cuda_cores(d, bin_size):
    assert st.scan_cores(torch.float32, d, bin_size) == "cuda"
    assert st.scan_cores("float32", d, bin_size) == "cuda"


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("bin_size", [8, 7, 100, 1000])
def test_bins_off_the_row_tile_stay_on_the_cuda_cores(kind, bin_size):
    assert bin_size % st.TC_ROW_TILE
    assert st.scan_cores(kind, 32, bin_size) == "cuda"


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_widths_above_128_stay_on_the_cuda_cores(kind):
    """They no longer do: widths above 128 take the tensor cores, with both
    operands staged in shared memory (f32 alone stays on the CUDA cores)."""
    assert st.scan_cores(kind, 160, 1024) == "tensor"


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("d_aug", [4, 20, 36, 44, 68, 132, 164, 260, 264])
def test_shifted_tensor_route_takes_any_multiple_of_4(kind, d_aug):
    assert st.shifted_cores(kind, d_aug) == "tensor"
    assert st.shifted_width(d_aug) == d_aug   # no padding up to 264


@pytest.mark.parametrize("d_aug", [20, 36, 68, 132])
def test_shifted_f32_and_small_bins_stay_on_the_cuda_cores(d_aug):
    assert st.shifted_cores(torch.float32, d_aug) == "cuda"
    assert st.shifted_cores(torch.bfloat16, d_aug, bin_size=8) == "cuda"
    assert st.shifted_width(d_aug) == d_aug


@pytest.mark.parametrize("kind,d_aug,bin_size,width", [
    (torch.float32, 166, 1024, 168),   # not a multiple of 4
    (torch.bfloat16, 34, 1024, 36),
    (torch.bfloat16, 270, 1024, 272),  # past the register budget as well
    (torch.float16, 268, 8, 272),      # a bin under the row tile: CUDA cores
])
def test_shifted_width_check_refuses(kind, d_aug, bin_size, width):
    """No width is refused any more: ``shifted_scan`` pads one no kernel
    takes with zero columns to ``shifted_width`` (a multiple of 4; of 8
    past 264), which gives the unpadded scan's winners exactly."""
    assert st.shifted_width(d_aug) == width
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(5, d_aug)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2 * bin_size, d_aug))
                         .astype(np.float32)).to(kind)
    got = st.shifted_scan(q, x, bin_size=bin_size)
    pad = st.shifted_scan_plain(
        torch.nn.functional.pad(q, (0, width - d_aug)),
        torch.nn.functional.pad(x, (0, width - d_aug)), bin_size=bin_size)
    assert torch.equal(got[0], pad[0]) and torch.equal(got[1], pad[1])


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("cores", [None, "tensor", "cuda"])
def test_a_route_asked_for_gives_the_same_scan(kind, cores):
    """``cores`` names a route (as chip_smoke.py does to time the CUDA-core
    kernel); on the CPU every route is the plain scan."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    alpha = None
    if kind == "int8":
        x = (x * 20).round().to(torch.int8)
        alpha = torch.full((5,), -2.0)
    else:
        x = x.to(getattr(torch, kind))
    add = torch.zeros(256)
    kw = dict(bin_size=64, chunk=256, packed=False, transpose=False,
              **(dict(quant=True) if kind == "int8" else dict(prescaled=True)))
    got = st.binned_scan(x[:5], x, add, alpha, cores=cores, **kw)
    ref = st.binned_scan_plain(x[:5], x, add, alpha, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind,d,bin_size,cores", [
    (torch.float32, 32, 1024, "tensor"),   # f32 has no tensor-core kernel
    (torch.bfloat16, 32, 8, "tensor"),     # nor a bin under the row tile
    (torch.float32, 160, 1024, "tensor"),  # nor f32 at d > 128
    (torch.bfloat16, 32, 1024, "gpu"),     # not a route
])
def test_a_route_the_kernel_lacks_is_refused(kind, d, bin_size, cores):
    x = torch.zeros((2 * bin_size, d), dtype=kind)
    with pytest.raises(ValueError, match="tensor-core kernel|cores is"):
        st.binned_scan(x[:3], x, torch.zeros(2 * bin_size),
                       bin_size=bin_size, cores=cores)


@pytest.mark.parametrize("kind,d_aug,cores,want", [
    (torch.bfloat16, 36, "cuda", "cuda"),
    (torch.float16, 132, "cuda", "cuda"),
    (torch.bfloat16, 164, "tensor", "tensor"),
    (torch.bfloat16, 164, "cuda", "cuda"),  # the wide CUDA-core kernel
    (torch.float32, 36, "tensor", None),   # f32 has no tensor-core kernel
])
def test_shifted_route_asked_for(kind, d_aug, cores, want):
    """A route asked for is taken where a kernel has it (on the CPU the
    plain scan's answer) and refused where none does."""
    q = torch.ones((3, d_aug), dtype=kind)
    x = torch.zeros((2048, d_aug), dtype=kind)
    if want is None:
        with pytest.raises(ValueError, match="tensor-core kernel"):
            st.shifted_scan(q, x, bin_size=1024, cores=cores)
    else:
        got = st.shifted_scan(q, x, bin_size=1024, cores=cores)
        ref = st.shifted_scan_plain(q, x, bin_size=1024)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind,cores", [(torch.float32, "tensor"),
                                        (torch.bfloat16, "gpu")])
def test_shifted_scan_refuses_a_route_it_lacks(kind, cores):
    q = torch.zeros((3, 36), dtype=kind)
    with pytest.raises(ValueError, match="tensor-core kernel|cores is"):
        st.shifted_scan(q, torch.zeros((64, 36), dtype=kind), bin_size=64,
                        cores=cores)


def test_shifted_scan_still_refuses_int8_and_a_mismatch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(256, 164)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(9, 164)).astype(np.float32))
    with pytest.raises(TypeError, match="int8"):
        st.shifted_scan(q, x.to(torch.int8), bin_size=64)
    with pytest.raises(ValueError, match="augment mismatch"):
        st.shifted_scan(q[:, :160], x.to(torch.bfloat16), bin_size=64)
    vals, ids = st.shifted_scan(q, x.to(torch.bfloat16), bin_size=64)
    assert vals.shape == ids.shape == (9, 4)


def test_wide_shifted_index_routes_to_the_tensor_cores():
    """A reduced width above 128 (160: d_aug 164), refused on the card
    before the tensor-core T3, now has a kernel; on the CPU its search is
    the plain scan's."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(3000, 160)).astype(np.float32)
    idx = st.FusedScanIndex(base, mode="shifted", chunk=1024, device="cpu")
    assert idx.x_aug.shape[1] == 164
    assert st.shifted_cores(idx.x_aug.dtype, 164, idx.bin_size) == "tensor"
    assert st.shifted_width(164) == 164
    ids, _ = idx.search(base[:20], k=1, c=16)
    assert (ids[:, 0].numpy() == np.arange(20)).all()


@pytest.mark.parametrize("acc", [-(1 << 22), -(1 << 22) + 1, -16129 * 256,
                                 -1, 0, 1, 12345, 16129 * 256, (1 << 22) - 1,
                                 1 << 22])
def test_int8_exact_convert(acc):
    """The tensor-core int8 scan starts its int32 sums at the bits of
    1.5 * 2^23 and reads the result as f32 less 1.5 * 2^23: exact for
    |acc| <= 2^22, which every d <= 256 meets (|x|, |q| <= 128)."""
    bits = np.array([acc + 0x4B400000], dtype=np.int32)
    got = bits.view(np.float32)[0] - np.float32(12582912.0)
    assert got == np.float32(acc)
    assert max(st.SCAN_WIDTHS) * 128 * 128 <= 1 << 22


def test_reset_sets_the_route_counts_to_zero():
    st.launches_by_cores.count("binned_scan:tensor")
    st.launches["binned_scan"] += 1
    st.reset_launches()
    assert not any(st.launches_by_cores.values())
    assert not any(st.launches.values())
    assert set(st.launches_by_cores) == {
        "binned_scan:tensor", "binned_scan:cuda", "shifted_scan:tensor",
        "shifted_scan:cuda", "gated_topm:tensor", "gated_topm:cuda"}


def test_cpu_scans_count_no_launch():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    st.reset_launches()
    st.binned_scan(x[:5].to(torch.bfloat16), x.to(torch.bfloat16),
                   torch.zeros(256), bin_size=64, chunk=256, packed=False,
                   prescaled=True, transpose=False)
    assert not any(st.launches_by_cores.values())


# ---- T4: gated_cores and gated_topm_scan(cores=)

def _gated_index(dtype="bfloat16", **kw):
    from gbnns_tpu_torch.search.gated import GatedScanIndex

    rng = np.random.default_rng(12)
    base = rng.normal(size=(4096, 32)).astype(np.float32)
    return base, GatedScanIndex(base, scan_dtype=dtype, kmeans_sample=None,
                                device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_gated_defaults_take_the_tensor_cores(dtype):
    """GatedScanIndex's defaults (fine 32, sub 1024, tq 512) and the tq its
    plan gives on the card (B rounded up to 128, at most 512)."""
    from gbnns_tpu_torch.search.gated import GatedScanIndex

    _, idx = _gated_index(dtype, chunk=1024, sub=512)
    defaults = {k: v.default for k, v in inspect.signature(
        GatedScanIndex).parameters.items()}
    assert (defaults["fine"], defaults["sub"], defaults["tq"],
            defaults["scan_dtype"]) == (32, 1024, 512, "bfloat16")
    assert idx.x_lo.dtype == getattr(torch, dtype)
    for tq in (128, 256, 384, 512):
        assert st.gated_cores(idx.x_lo.dtype, 32, fine=32,
                              tq=tq) == "tensor"
    assert st.gated_cores(dtype, idx.x_lo.shape[1], fine=idx.fine,
                          tq=128) == "tensor"


@pytest.mark.parametrize("d,warp", [(16, 64), (32, 64), (64, 32),
                                    (128, 16)])
@pytest.mark.parametrize("fine", [16, 32, 128])
def test_gated_tensor_route_widths(d, warp, fine):
    assert st.tc_warp_queries(d) == warp
    for kind in ("bfloat16", "float16", torch.bfloat16, torch.float16):
        assert st.gated_cores(kind, d, fine=fine, tq=warp) == "tensor"


@pytest.mark.parametrize("kind,d,fine,tq", [
    (torch.float32, 32, 32, 512),    # f32: TF32 would change the result
    ("float32", 16, 16, 64),
    (torch.bfloat16, 32, 4, 512),    # fine groups under the row tile
    (torch.float16, 32, 8, 512),
    (torch.bfloat16, 32, 32, 32),    # a tile of half a warp's queries
    (torch.bfloat16, 32, 32, 96),    # a tile that splits a warp
    (torch.float16, 64, 32, 48),
    (torch.bfloat16, 128, 16, 8),
    (torch.bfloat16, 24, 32, 512),   # no kernel width
])
def test_gated_shapes_that_stay_on_the_cuda_cores(kind, d, fine, tq):
    assert st.gated_cores(kind, d, fine=fine, tq=tq) == "cuda"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("cores", [None, "tensor", "cuda"])
def test_a_gated_route_asked_for_gives_the_plain_scan(dtype, cores):
    """``cores`` names a route (chip_smoke.py times the CUDA-core T4 so);
    on the CPU every route is the plain scan. f32 has no tensor route."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32))
    add = (x ** 2).sum(-1)
    keep = torch.from_numpy((rng.random(8 * 2) < 0.5).astype(np.int32))
    kw = dict(fine=32, m=16, sub=256, chunk=512, tq=64)
    x, q = (-2 * x).to(dtype), q.to(dtype)
    ref = st.gated_topm_scan_plain(q, x, add, keep, **kw)
    if dtype == torch.float32 and cores == "tensor":
        with pytest.raises(ValueError, match="tensor-core kernel"):
            st.gated_topm_scan(q, x, add, keep, cores=cores, **kw)
        return
    st.reset_launches()
    got = st.gated_topm_scan(q, x, add, keep, cores=cores, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert not any(st.launches_by_cores.values())   # CPU: no launch


@pytest.mark.parametrize("kind,fine,tq,cores", [
    (torch.float32, 32, 64, "tensor"),    # f32 has no tensor-core kernel
    (torch.bfloat16, 8, 64, "tensor"),    # nor fine groups under 16 rows
    (torch.bfloat16, 32, 32, "tensor"),   # nor a tile that splits a warp
    (torch.bfloat16, 32, 64, "gpu"),      # not a route
    (torch.bfloat16, 32, 64, "Tensor"),
])
def test_a_gated_route_the_kernel_lacks_is_refused(kind, fine, tq, cores):
    x = torch.zeros((1024, 32), dtype=kind)
    keep = torch.ones(2 * (128 // tq), dtype=torch.int32)
    with pytest.raises(ValueError, match="tensor-core kernel|cores is"):
        st.gated_topm_scan(x[:128], x, torch.zeros(1024), keep, fine=fine,
                           m=4, sub=64, chunk=512, tq=tq, cores=cores)


def test_gated_search_routes_its_scan(monkeypatch):
    """GatedScanIndex.search hands T4 no route of its own: the wrapper takes
    ``gated_cores``'s choice for the plan's tq."""
    base, idx = _gated_index(chunk=1024, sub=512)
    seen = []
    real = st.gated_cores

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(st, "gated_cores", spy)
    ids, _ = idx.search(base[:64], k=1, probes=4)
    assert (ids[:, 0].numpy() == np.arange(64)).all()
    assert seen == ["tensor"]   # the CPU plan's tq is 64: one warp's
