"""The PyTorch port's neighbor sampler against the JAX package's: the
same graph (an R-MAT graph from each package's generator, equal edge for
edge), fanouts and seed give the same four arrays (nodes, src, dst and
the count of real nodes), element for element, over several batches
drawn one after another; the padding follows the models' sentinel
convention. A few hypothesis examples vary the seeds, batch size and
fanouts."""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

from _hyp import given, settings, strategies as st

import repro.graph as jgraph
from repro.graph.sampler import NeighborSampler as JaxSampler

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.graph as tgraph  # noqa: E402
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402

GRAPHS = {}


def _graphs(scale, seed):
    if (scale, seed) not in GRAPHS:
        GRAPHS[scale, seed] = (
            jgraph.rmat_graph(scale=scale, edge_factor=4, seed=seed),
            tgraph.rmat_graph(scale=scale, edge_factor=4, seed=seed))
    return GRAPHS[scale, seed]


def _same_draws(gj, gt, fanouts, seed, batch, n_batches=3):
    sj = JaxSampler(gj, fanouts, seed=seed)
    s = NeighborSampler(gt, fanouts, seed=seed)
    assert s.max_nodes(batch) == sj.max_nodes(batch)
    assert s.max_edges(batch) == sj.max_edges(batch)
    pick = np.random.default_rng(seed + 1)
    for _ in range(n_batches):
        seeds = pick.choice(gt.n_vertices, batch, replace=False)
        want, got = sj.sample(seeds), s.sample(seeds)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("fanouts,batch", [((10, 5), 64), ((15, 10), 16),
                                           ((3,), 1)])
def test_sampler_arrays_equal_reference(fanouts, batch):
    gj, gt = _graphs(9, 0)
    nodes, src, dst, n_real = _same_draws(gj, gt, fanouts, 0, batch)
    max_n = len(nodes)
    assert (nodes[n_real:] == gt.n_vertices).all()
    real = src < max_n
    assert (dst[real] < n_real).all() and (src[real] < n_real).all()
    assert (src[~real] == max_n).all() and (dst[~real] == max_n).all()
    assert real.any()


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1), batch=st.integers(min_value=1, max_value=48),
       f1=st.integers(min_value=1, max_value=12),
       f2=st.integers(min_value=0, max_value=6))
def test_sampler_arrays_equal_reference_hypothesis(seed, batch, f1, f2):
    gj, gt = _graphs(8, 1)
    fanouts = (f1,) if f2 == 0 else (f1, f2)
    _same_draws(gj, gt, fanouts, seed, batch, n_batches=2)
