"""Projection load side: the port's loader and models against the JAX
package's on the same checkpoints and parameters (JAX on the CPU)."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from gbnns_tpu.dimred import models as jax_models
from gbnns_tpu.dimred import train as jax_train
from gbnns_tpu_torch.dimred.models import make_model
from gbnns_tpu_torch.dimred.train import (load_projection, params_from_jax,
                                          project, projector)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKPOINTS = ["bench_proj_n1000000_d128x32_s600_sel_seed1.npz",
               "ab_proj_sift_mlp32_n1000000_s600.npz",
               "proj_glove_300x96_s1200_sel_seed1.npz"]


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_load_projection_then_project_matches_jax(name):
    path = str(ROOT / "results" / name)
    ref = jax_train.load_projection(path)
    mine = load_projection(path, device="cpu")
    assert mine["cfg"].d_out == ref["cfg"].d_out
    assert mine["cfg"].model == ref["cfg"].model
    d_in = next(iter(mine["model"].parameters())).shape[1]
    x = np.random.default_rng(0).normal(size=(257, d_in)).astype(np.float32)
    # the JAX CPU product is fp32 too; outputs are O(1)-O(10)
    np.testing.assert_allclose(project(mine, x, chunk=100),
                               jax_train.project(ref, x), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["linear", "mlp"])
@pytest.mark.parametrize("normalize", [False, True])
def test_params_from_jax_gives_equal_outputs(kind, normalize):
    d_in, d_out, hidden = 48, 16, 64
    jm = jax_models.make_model(kind, d_out, hidden=hidden, normalize=normalize)
    params = jax_models.init_model(jm, d_in, seed=3)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    model = make_model(kind, d_in, d_out, hidden=hidden, normalize=normalize)
    model.load_state_dict(params_from_jax(flat))
    x = np.random.default_rng(1).normal(size=(33, d_in)).astype(np.float32)
    ref = np.asarray(jax_models.apply_model(jm, params, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_params_from_jax_rejects_unknown_leaf():
    with pytest.raises(ValueError):
        params_from_jax({"params/other/kernel": np.zeros((2, 2))})


def test_projector_equals_project():
    trained = load_projection(
        str(ROOT / "results" / CHECKPOINTS[0]), device="cpu")
    x = np.random.default_rng(2).normal(size=(20, 128)).astype(np.float32)
    out = projector(trained)(torch.from_numpy(x))
    assert not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), project(trained, x))
