"""The generator: deterministic in the seed, at its stated shape."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.generators import ssn

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def ssn_base():
    return ssn.base(config("ssn-recourse"))


def same(a, b):
    return all(np.array_equal(a[k].toarray() if k == "A" else a[k],
                              b[k].toarray() if k == "A" else b[k]) for k in a)


def test_ssn_shape_and_structure(ssn_base):
    cfg = config("ssn-recourse")
    A = ssn_base["A"]
    assert A.shape == (cfg["rows"], cfg["columns"]) == (175, 706)
    links, demands, paths = cfg["links"], cfg["demands"], cfg["paths"]
    assert links + demands == 175 and paths + demands == 706
    dense = A.toarray()
    # each path column: its links (>= 1) and its demand row; each shortfall
    # column: its demand row alone; the cost is the shortfall
    assert (dense[links:, :paths].sum(0) == 1).all() and (dense[:links, :paths].sum(0) >= 1).all()
    shortfall = np.vstack([np.zeros((links, demands)), np.eye(demands)])
    assert np.array_equal(dense[:, paths:], shortfall)
    assert np.array_equal(ssn_base["c"], np.r_[np.zeros(paths), np.ones(demands)])
    per = dense[links:, :paths].sum(1)
    assert set(per) <= {7, 8} and per.sum() == paths


def test_ssn_batches_follow_the_seed(ssn_base):
    cfg = config("ssn-recourse")
    a = ssn.batch(cfg, ssn_base, np.random.default_rng(2**31 + 7), 16)
    b = ssn.batch(cfg, ssn_base, np.random.default_rng(2**31 + 7), 16)
    c = ssn.batch(cfg, ssn_base, np.random.default_rng(2**31 + 8), 16)
    assert same(a, b) and not np.array_equal(a["ru"], c["ru"])
    assert a["rl"].shape == a["ru"].shape == (16, 175)
    # capacities (<= rows) are one per call, demands (= rows) one per lane
    assert (a["ru"][:, :89] == a["ru"][:1, :89]).all() and np.isinf(a["rl"][:, :89]).all()
    assert np.array_equal(a["rl"][:, 89:], a["ru"][:, 89:])
    assert len({tuple(r) for r in a["rl"][:, 89:]}) > 1


def test_ssn_network_is_fixed():
    cfg = config("ssn-recourse")
    assert same({k: v for k, v in ssn.base(cfg).items() if k != "levels"},
                {k: v for k, v in ssn.base(cfg).items() if k != "levels"})
