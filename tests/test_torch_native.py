"""The port's ctypes binding of the C++ reference engine (``native.py``)
against the JAX package's on the fixture corpus: both load the library that
``make -C native`` builds, and give equal arrays for ``knn_build``,
``beam_search`` and ``rerank``. The oracle then holds the port's own exact
kNN build (distances within 1e-3: neighbour ids may differ at ties). Skips
where the toolchain cannot build the library, as the JAX package's tests
do."""

import numpy as np
import pytest

from gbnns_tpu import native as jax_native
from gbnns_tpu_torch import native


@pytest.fixture(scope="module")
def lib_ready():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    assert jax_native.available()


@pytest.fixture(scope="module")
def graph(fixture_data, lib_ready):
    base, _ = fixture_data
    return native.knn_build(base, 8)


def test_knn_build_equals_jax(fixture_data, graph):
    base, _ = fixture_data
    np.testing.assert_array_equal(graph, jax_native.knn_build(base, 8))
    assert graph.shape == (2048, 8) and graph.dtype == np.int32
    ip = native.knn_build(base[:512], 4, metric="ip")
    np.testing.assert_array_equal(ip, jax_native.knn_build(base[:512], 4,
                                                           metric="ip"))


def test_beam_search_equals_jax(fixture_data, graph):
    base, query = fixture_data
    entries = np.arange(0, 2048, 128, dtype=np.int32)
    got = native.beam_search(base, graph, query, entries, ef=32)
    want = jax_native.beam_search(base, graph, query, entries, ef=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, dists, ndist = got
    assert ids.shape == dists.shape == (query.shape[0], 32)
    assert (np.diff(dists, axis=1) >= 0).all() and (ndist > 0).all()


def test_rerank_equals_jax(fixture_data, graph):
    base, query = fixture_data
    cand = graph[:query.shape[0]]
    for g, w in zip(native.rerank(base, query, cand, 5),
                    jax_native.rerank(base, query, cand, 5)):
        np.testing.assert_array_equal(g, w)
    assert native.num_threads() == jax_native.num_threads() >= 1


def test_port_exact_build_agrees_with_the_oracle(fixture_data, graph):
    from gbnns_tpu_torch.build.knn_graph import build_knn_graph

    base, _ = fixture_data
    mine = build_knn_graph(base, 8, reverse_frac=0.0, connect=False,
                           device="cpu")
    d2 = ((base[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(
        np.sort(np.take_along_axis(d2, mine, axis=1), 1),
        np.sort(np.take_along_axis(d2, graph, axis=1), 1),
        rtol=1e-3, atol=1e-3)
