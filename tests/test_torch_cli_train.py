"""The port's ``synth``, ``gt`` and ``train`` subcommands against the JAX
package's CLI on the same files, on the CPU at n = 2,000 (sift1m's
synthetic stand-in at scale 0.002).

Tolerances: the synthesized fvecs and the ground-truth ivecs are equal byte
for byte; the PCA npz (mean, components) is equal up to each component's
sign within 1e-4, and the projected fvecs (values in the tens) within
1e-3; the linear projection's checkpoint loads in the JAX package and
projects as the port's ``base_lo.fvecs`` within 1e-5."""

import numpy as np
import pytest

from gbnns_tpu import cli as jax_cli
from gbnns_tpu.dimred import train as jax_train
from gbnns_tpu_torch import cli
from gbnns_tpu_torch.io.vecs import read_fvecs, read_ivecs


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["synth", "--dataset", "sift1m", "--scale", "0.002", "--out",
              str(root / name)])
    return root


def test_synth_writes_what_jax_writes(staged):
    for f in ("base.fvecs", "query.fvecs"):
        assert (staged / "port" / f).read_bytes() == \
            (staged / "jax" / f).read_bytes()
    assert read_fvecs(str(staged / "port" / "base.fvecs")).shape == (2000, 128)


def _data_args(staged):
    return ["--base", str(staged / "port" / "base.fvecs"), "--query",
            str(staged / "port" / "query.fvecs")]


def test_gt_equals_jax(staged):
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        main(["gt", *_data_args(staged), "--k", "20", "--out",
              str(staged / f"gt_{name}.ivecs"), *extra])
    got = read_ivecs(str(staged / "gt_port.ivecs"))
    want = read_ivecs(str(staged / "gt_jax.ivecs"))
    assert got.shape == (want.shape[0], 20)
    np.testing.assert_array_equal(got, want)


def test_train_pca_equals_jax_up_to_sign(staged):
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        main(["train", *_data_args(staged), "--method", "pca", "--d-out",
              "16", "--out", str(staged / f"pca_{name}"), *extra])
    got = np.load(staged / "pca_port" / "pca.npz")
    want = np.load(staged / "pca_jax" / "pca.npz")
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5,
                               atol=1e-6)
    sign = np.sign((got["components"] * want["components"]).sum(0))
    np.testing.assert_allclose(got["components"] * sign, want["components"],
                               atol=1e-4)
    for f in ("base_lo.fvecs", "query_lo.fvecs"):
        mine = read_fvecs(str(staged / "pca_port" / f))
        ref = read_fvecs(str(staged / "pca_jax" / f))
        np.testing.assert_allclose(mine * sign, ref, atol=1e-3)


def test_train_linear_writes_a_checkpoint_jax_loads(staged):
    out = staged / "linear_port"
    cli.main(["train", *_data_args(staged), "--method", "linear", "--d-out",
              "16", "--steps", "10", "--batch-size", "128", "--eval-every",
              "5", "--out", str(out), "--device", "cpu"])
    ref = jax_train.load_projection(str(out / "proj.npz"))
    assert ref["cfg"].d_out == 16 and ref["cfg"].eval_every == 5
    base = read_fvecs(str(staged / "port" / "base.fvecs"))
    np.testing.assert_allclose(read_fvecs(str(out / "base_lo.fvecs")),
                               jax_train.project(ref, base), atol=1e-5)
    assert read_fvecs(str(out / "query_lo.fvecs")).shape[1] == 16
