"""The port's multi-process backend (``backend="shmap"``, one gloo rank a
shard, 4 CPU ranks) against the port's sim backend on the same shards,
tolerance zero: every exchange x staged and fused x toka0-3 on the
reference's fixture graph. Every rank must return the same result, and
it must equal the sim engine's in distances, every counter, status and
the engine's accounting. The ranks start once for the whole matrix
(``_torch_dist_ref.run_ranks``); each case is one comparison.
"""
import itertools

import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as ref  # noqa: E402

EXCHANGES = ("bucket", "pmin", "a2a_dense", "async", "async_bucket",
             "async_ppermute")
SCENARIOS = {
    f"{ex}-{rnd}-{toka}": dict(cfg=dict(exchange=ex, round=rnd, toka=toka))
    for ex, rnd, toka in itertools.product(
        EXCHANGES, ("staged", "fused"), ("toka0", "toka1", "toka2", "toka3"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario on 4 ranks (each rank's list of results) and on the
    sim engine, solved while the ranks run."""
    return ref.run_ranks(
        ref.rank_scenarios, tmp_path_factory.mktemp("dist_solve"),
        list(SCENARIOS.values()), world=4,
        meanwhile=lambda: [ref.sim_scenario(sc) for sc in SCENARIOS.values()])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_shmap_matches_sim(ranks, name):
    per_ranks, sims = ranks
    i = list(SCENARIOS).index(name)
    want = sims[i]
    for per_rank in per_ranks:
        ref.assert_same_scenario(per_rank[i], want)
