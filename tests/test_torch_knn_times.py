"""The T6 timing tool ``kernels.knn_times`` on the CPU, at a small size: one
record a (d, k), whose sums are those of the plain kNN on the same seeded
inputs (on the CPU ``knn_topk`` is the plain version; its time is the
host's and is only checked to be positive)."""

import json

import torch

from gbnns_tpu_torch.kernels import distance_topk as dt
from gbnns_tpu_torch.kernels import knn_times


def test_knn_times_records_each_width_and_k(capsys):
    recs = knn_times.main(["--device", "cpu", "--nq", "20", "--n", "300",
                           "--widths", "8,24", "--ks", "1,5", "--reps", "1",
                           "--seed", "4"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [(r["d"], r["k"]) for r in recs] == [(8, 1), (8, 5), (24, 1),
                                                (24, 5)]
    for r in recs:
        gen = torch.Generator().manual_seed(4 + r["d"])
        x = torch.randn((300, r["d"]), generator=gen)
        q = torch.randn((20, r["d"]), generator=gen)
        dists, ids = dt.knn_topk_plain(q, x, r["k"])
        assert r["id_sum"] == int(ids.long().sum())
        assert r["dist_sum"] == float(dists.double().sum())
        assert r["ms"] > 0 and r["device"] == "cpu"
        assert (r["nq"], r["n"], r["reps"]) == (20, 300, 1)
