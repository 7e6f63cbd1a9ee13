"""PCA (``dimred/pca.py``) and the projection trainer (``dimred/train.py``)
against the JAX package's on the same numpy inputs (JAX on the CPU).

Tolerances:
  * PCA: components equal up to the sign of each column within 1e-4
    absolute; mean and explained variance within 1e-5 relative (both
    decompose the same fp32 covariance, summed in another order);
  * the step-0 validation score (``steps=0``, ``val_queries`` >= n, so both
    score every row whatever their permutations) equal to JAX's within
    2 / (10 n): two of the 10 n neighbour slots may flip at an fp32 tie;
  * twenty steps fed JAX's own batch draws (made here with ``jax.random``
    as ``train.py`` makes them, and passed through the port's
    ``draw_batch``): losses within 1e-4 relative, final parameters within
    1e-4 absolute;
  * checkpoints: each package loads the other's file, and the two
    projections agree within 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gbnns_tpu.dimred import pca as jax_pca
from gbnns_tpu.dimred import train as jax_train
from gbnns_tpu.eval.recall import exact_ground_truth
from gbnns_tpu_torch.dimred import pca, train


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    n, d = 1500, 32
    cents = rng.normal(size=(24, d)) * 2.0
    base = (cents[rng.integers(0, 24, n)] + rng.normal(size=(n, d))
            * np.linspace(1.5, 0.3, d)).astype(np.float32)
    nbrs = exact_ground_truth(base, base, k=21)[:, 1:]
    return base, nbrs


def _sign(ref, got):
    return np.sign((ref * got).sum(axis=0))


def test_pca_matches_jax_up_to_sign(corpus):
    x, _ = corpus
    ref = jax_pca.pca_fit(x, 12, chunk=512)
    got = pca.pca_fit(x, 12, chunk=512, device="cpu")
    s = _sign(ref.components, got.components)
    np.testing.assert_allclose(got.components * s, ref.components, atol=1e-4)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.explained_variance,
                               ref.explained_variance, rtol=1e-5)
    assert (np.diff(got.explained_variance) <= 0).all()
    for normalize in (False, True):
        np.testing.assert_allclose(
            pca.pca_transform(got, x[:100], normalize=normalize,
                              device="cpu") * s,
            jax_pca.pca_transform(ref, x[:100], normalize=normalize),
            atol=1e-4)


def test_pca_rejects_too_many_components(corpus):
    with pytest.raises(ValueError, match="d_out"):
        pca.pca_fit(corpus[0], 33, device="cpu")


def _cfg(cls, **kw):
    base = dict(d_out=8, steps=20, batch_size=128, k_pos=10, seed=3)
    return cls(**{**base, **kw})


def test_step0_val_equals_jax(corpus):
    base, nbrs = corpus
    n = base.shape[0]
    kw = dict(steps=0, eval_every=5, val_queries=n)
    ref = jax_train.train_projection(base, nbrs, _cfg(jax_train.TrainConfig,
                                                      **kw))
    got = train.train_projection(base, nbrs, _cfg(train.TrainConfig, **kw),
                                 device="cpu")
    assert len(got["val_history"]) == 1 and got["best_step"] == 0
    assert abs(got["val_history"][0] - ref["val_history"][0]) \
        <= 2 / (10 * n)


def _jax_draws(cfg, n):
    """JAX's draws for ``cfg.steps`` steps without validation: one key a
    step split from PRNGKey(seed + 1), each split in three (anchor,
    positive column, negative)."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(cfg.seed + 1), cfg.steps):
        ka, kp, kn = jax.random.split(key, 3)
        a = jax.random.randint(ka, (cfg.batch_size,), 0, n)
        p = jax.random.randint(kp, (cfg.batch_size,), 0, cfg.k_pos)
        if cfg.neg_ranks is not None:
            ng = jax.random.randint(kn, (cfg.batch_size,), cfg.neg_ranks[0],
                                    cfg.neg_ranks[1])
        else:
            ng = jax.random.randint(kn, (cfg.batch_size,), 0, n)
        out.append(tuple(torch.from_numpy(np.asarray(v, np.int64))
                         for v in (a, p, ng)))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(metric="ip", neg_ranks=(10, 20)),
    dict(hard_negatives=False, init="pca", lr=3e-3),
], ids=["l2-hard", "ip-neg-ranks", "l2-plain"])
def test_twenty_steps_replay_jax(corpus, monkeypatch, kw):
    base, nbrs = corpus
    cfg = _cfg(jax_train.TrainConfig, **kw)
    ref = jax_train.train_projection(base, nbrs, cfg)
    draws = iter(_jax_draws(cfg, base.shape[0]))
    monkeypatch.setattr(train, "draw_batch", lambda gen, n, c: next(draws))
    got = train.train_projection(
        base, nbrs, train.TrainConfig(**dataclasses.asdict(cfg)),
        device="cpu")
    np.testing.assert_allclose(got["losses"], np.asarray(ref["losses"]),
                               rtol=1e-4)
    w = got["model"].proj.weight.detach().numpy().T
    np.testing.assert_allclose(
        w, np.asarray(ref["params"]["params"]["proj"]["kernel"]), atol=1e-4)


def test_draw_batch_ranges(corpus):
    gen = torch.Generator().manual_seed(0)
    cfg = _cfg(train.TrainConfig, neg_ranks=(10, 20))
    a, p, ng = train.draw_batch(gen, 1500, cfg)
    assert a.shape == p.shape == ng.shape == (128,)
    assert 0 <= int(a.min()) and int(a.max()) < 1500
    assert 0 <= int(p.min()) and int(p.max()) < 10
    assert 10 <= int(ng.min()) and int(ng.max()) < 20


def test_same_seed_same_params_and_selection_never_below_init(corpus):
    base, nbrs = corpus
    cfg = _cfg(train.TrainConfig, steps=30, eval_every=10, init="orthogonal")
    one = train.train_projection(base, nbrs, cfg, device="cpu")
    two = train.train_projection(base, nbrs, cfg, device="cpu")
    for k, v in one["model"].state_dict().items():
        assert torch.equal(v, two["model"].state_dict()[k]), k
    hist = one["val_history"]
    assert len(hist) == 4 and one["best_val"] == hist.max()
    assert one["best_val"] >= hist[0]
    assert one["losses"].shape == (30,) and np.isfinite(one["losses"]).all()


def test_neighbor_columns_are_checked(corpus):
    base, nbrs = corpus
    with pytest.raises(ValueError, match="columns"):
        train.train_projection(base, nbrs[:, :5], _cfg(train.TrainConfig),
                               device="cpu")
    with pytest.raises(ValueError, match="neg_ranks"):
        train.train_projection(base, nbrs,
                               _cfg(train.TrainConfig, neg_ranks=(5, 8)),
                               device="cpu")


@pytest.mark.parametrize("model", ["linear", "mlp"])
def test_checkpoints_load_in_both_packages(corpus, tmp_path, model):
    base, nbrs = corpus
    x = base[:64]
    # the port's checkpoint, read by JAX
    cfg = _cfg(train.TrainConfig, model=model, hidden=16, steps=3,
               init="orthogonal")
    mine = train.train_projection(base, nbrs, cfg, device="cpu")
    path = str(tmp_path / "port.npz")
    train.save_projection(path, mine)
    ref = jax_train.load_projection(path)
    assert ref["cfg"] == jax_train.TrainConfig(**dataclasses.asdict(cfg))
    np.testing.assert_allclose(jax_train.project(ref, x),
                               train.project(mine, x), atol=1e-5)
    # JAX's checkpoint, read by the port
    jcfg = _cfg(jax_train.TrainConfig, model=model, hidden=16, steps=3,
                init="orthogonal")
    jtrained = jax_train.train_projection(base, nbrs, jcfg)
    jpath = str(tmp_path / "jax.npz")
    jax_train.save_projection(jpath, jtrained)
    loaded = train.load_projection(jpath, device="cpu")
    np.testing.assert_allclose(train.project(loaded, x),
                               jax_train.project(jtrained, x), atol=1e-5)
    # the port's own round trip keeps the config
    again = train.load_projection(path, device="cpu")
    assert again["cfg"] == cfg
    np.testing.assert_allclose(train.project(again, x),
                               train.project(mine, x), atol=1e-6)


def test_pca_init_is_pca(corpus):
    base, nbrs = corpus
    got = train.train_projection(base, nbrs, _cfg(train.TrainConfig,
                                                  steps=0), device="cpu")
    comps = pca.pca_fit(base, 8, device="cpu").components
    np.testing.assert_array_equal(
        got["model"].proj.weight.detach().numpy().T, comps)
