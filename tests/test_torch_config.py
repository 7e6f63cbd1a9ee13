"""The port's ``ExperimentConfig`` against the JAX package's: the same
fields, defaults and order, so every checked-in config and every saved
config loads to an equal ``to_json()`` in both packages."""

import dataclasses
import json
import pathlib

import pytest

from gbnns_tpu import config as jax_config
from gbnns_tpu_torch import config

CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1]
                  / "configs").glob("*.json"))


def test_round_trip(tmp_path):
    cfg = config.ExperimentConfig(name="x", dataset="glove", metric="angular",
                                  n_devices=4)
    cfg.dimred.neg_ranks = (10, 40)
    cfg.search.efs = (8, 16)
    p = str(tmp_path / "c.json")
    cfg.save(p)
    loaded = config.ExperimentConfig.load(p)
    assert loaded == cfg
    assert loaded.dimred.neg_ranks == (10, 40)
    assert config.ExperimentConfig.load(p, out_dir="elsewhere").out_dir == \
        "elsewhere"


@pytest.mark.parametrize("name", ["GraphConfig", "DimRedConfig",
                                  "SearchConfig", "ExperimentConfig"])
def test_fields_and_defaults_equal_jax(name):
    mine = [(f.name, f.type) for f in dataclasses.fields(getattr(config,
                                                                 name))]
    ref = [(f.name, f.type) for f in dataclasses.fields(getattr(jax_config,
                                                                name))]
    assert mine == ref
    assert dataclasses.asdict(getattr(config, name)()) == \
        dataclasses.asdict(getattr(jax_config, name)())


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_checked_in_configs_load_as_in_jax(path):
    mine = config.ExperimentConfig.load(str(path)).to_json()
    ref = jax_config.ExperimentConfig.load(str(path)).to_json()
    assert mine == ref
    assert json.dumps(mine) == json.dumps(ref)


def test_saved_by_one_package_loads_in_the_other(tmp_path):
    path = CONFIGS[0]
    jax_config.ExperimentConfig.load(str(path)).save(str(tmp_path / "j.json"))
    config.ExperimentConfig.load(str(path)).save(str(tmp_path / "p.json"))
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "p.json").read_text()
    assert config.ExperimentConfig.load(str(tmp_path / "j.json")).to_json() \
        == jax_config.ExperimentConfig.load(str(tmp_path / "p.json")).to_json()
