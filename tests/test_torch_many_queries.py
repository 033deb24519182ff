"""The PyTorch port's engine against the JAX package's at many queries.

K = 300 sources ride the bucket of 512, which the card's kernels 3-6 split
into query groups (their tiles of minima for 512 queries do not fit in
shared memory a block). On the CPU the kernels' plain versions run, so
this holds the engine's batch of 512 rows against the JAX engine's: the
all-kernel staged config and the fused round on an R-MAT graph (scale 8,
193 vertices with an out-edge, so the 300 sources repeat some), P = 4;
distances bit-identical, every counter and ``status`` equal. The card's
group split itself is held against the plain versions by
``test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402

CONFIGS = {"all-kernel": dict(local_solver="pallas", send_backend="pallas",
                              merge_backend="pallas", round="staged",
                              exchange="bucket", toka="toka0"),
           "fused": dict(round="fused")}
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_reference_at_300_queries(config):
    g = jg.rmat_graph(scale=8, edge_factor=4, seed=1)
    sj = jc.build_shards(g, 4)
    deg = np.diff(np.asarray(g.row_ptr))
    srcs = [int(s) for s in np.random.default_rng(0).choice(
        np.nonzero(deg)[0], 300)]
    cfg = CONFIGS[config]
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    rt = tc.SsspEngine.build(tc.shards_from_arrays(fields, **static),
                             tc.SsspConfig(**cfg), device="cpu").solve(srcs)
    assert rj.status == "converged" and rj.bucket_k == rt.bucket_k == 512
    np.testing.assert_array_equal(rt.dist, np.asarray(rj.dist))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    assert rt.status == rj.status
