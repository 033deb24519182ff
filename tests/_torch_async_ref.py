"""Shared pieces of the asynchronous-mode and fault tests of the PyTorch
port (test_torch_async*.py, test_torch_toka.py, test_torch_faults*.py):
JAX shards read into the port, the result comparison (tolerance zero), and
the reference's fixtures."""
import dataclasses

import numpy as np

import repro.core as jc
import repro.graph as jg
import repro_torch.core as tc

EXCHANGES = ("bucket", "pmin", "a2a_dense", "async", "async_bucket",
             "async_ppermute")
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "stale_merges", "overlap_rounds", "bytes_moved", "n_dispatches",
            "resends")
SOURCES = [0, 7, 11]       # tests/test_async_exchange.py's fixture sources


def port_shards(sj):
    """JAX ``SsspShards`` read out as numpy into the port's."""
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return tc.shards_from_arrays(fields, **static)


def fixture_shards():
    """The reference's fixture: ``random_graph(n=180, m=720, seed=3)`` on
    P=4, as (JAX shards, port shards, graph)."""
    g = jg.random_graph(n=180, m=720, seed=3)
    sj = jc.build_shards(g, 4)
    return sj, port_shards(sj), g


def fault_fixture_shards():
    """tests/test_faults.py's fixture: ``random_graph(n=96, m=360,
    seed=7)`` on P=4, no triangles; (JAX shards, port shards, graph)."""
    g = jg.random_graph(n=96, m=360, seed=7)
    sj = jc.build_shards(g, 4, enumerate_triangles=False)
    return sj, port_shards(sj), g


def assert_results_equal(rt, rj):
    np.testing.assert_array_equal(rt.dist, np.asarray(rj.dist))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    assert rt.status == rj.status


def solve_both(sj, st, srcs, **cfg):
    """One config solved by both engines (the port on the CPU); fails
    unless they agree. Returns (port result, JAX result)."""
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(st, tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert_results_equal(rt, rj)
    return rt, rj


def solve_faulted(sj, st, srcs, plan: dict, **cfg):
    """One faulted config solved by both engines (the port on the CPU),
    each with its own package's ``FaultPlan``; fails unless they agree.
    Returns (port result, JAX result)."""
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(
        faults=jc.FaultPlan(**plan), **cfg)).solve(srcs)
    rt = tc.SsspEngine.build(st, tc.SsspConfig(
        faults=tc.FaultPlan(**plan), **cfg), device="cpu").solve(srcs)
    assert_results_equal(rt, rj)
    return rt, rj
