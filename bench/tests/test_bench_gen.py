"""The frozen generator draws what the program's ``workload`` streams
draw, round for round, on one seed."""
import dataclasses

import pytest
import torch

from bench import gen
from repro_torch.db import tpcc, workload


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]


@pytest.mark.parametrize("driver", ["mixed", "neworder"])
def test_frozen_generator_equals_the_programs(driver):
    cfg = tpcc.TPCCConfig(n_warehouses=5, customers_per_district=40,
                          n_items=300, n_threads=16)
    rcfg = dataclasses.asdict(cfg)
    theirs = (workload.mixed_stream if driver == "mixed"
              else workload.neworder_stream)(
        cfg, torch.Generator().manual_seed(77))
    ours = gen.round_source(workload, rcfg, {"driver": driver},
                            torch.Generator().manual_seed(77))
    for r in range(4):
        a, b = _leaves(theirs(r)), _leaves(ours(r))
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_horizon_indexes_and_ends():
    rcfg = dict(n_warehouses=3, customers_per_district=10, n_items=50,
                n_threads=4, dist_degree=10.0)
    h = gen.horizon(workload, rcfg, {"driver": "mixed"}, 2**31 + 5, 3, "cpu")
    h2 = gen.horizon(workload, rcfg, {"driver": "mixed"}, 2**31 + 5, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(h.draw(2)),
                                                 _leaves(h2.draw(2))))
    with pytest.raises(RuntimeError):
        h.draw(3)
