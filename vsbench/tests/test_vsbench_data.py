"""The device data generator: the same seed gives the same rows."""

import torch

from vsbench import data, spec

SPEC = {"n_rows": 3000, "dim": 96, "n_queries": 50, "intrinsic_dim": 24, "noise": 0.05}


def test_same_seed_same_rows_other_seed_other_rows():
    a = data.make(SPEC, 2**31 + 7, "cpu")
    b = data.make(SPEC, 2**31 + 7, "cpu")
    c = data.make(SPEC, 2**31 + 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3000, 96) and a[1].shape == (50, 96) and a[0].dtype == torch.float32


def test_unit_norm_rows_and_queries():
    base, queries = data.make(dict(SPEC, unit_norm=True), 5, "cpu")
    for x in (base, queries):
        torch.testing.assert_close(torch.linalg.vector_norm(x, dim=1),
                                   torch.ones(x.shape[0]), rtol=0, atol=1e-6)


def test_configs_state_the_published_shapes():
    bm = spec.benchmark()
    sift = spec.config(bm, "ivfpq-sift1m")
    deep = spec.config(bm, "ivfflat-deep10m")
    assert (sift["data"]["n_rows"], sift["data"]["dim"], sift["data"]["n_queries"]) == \
        (1_000_000, 128, 10_000)
    assert (deep["data"]["n_rows"], deep["data"]["dim"], deep["data"]["unit_norm"]) == \
        (9_990_000, 96, True)
