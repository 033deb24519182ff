"""``sim_phase_fns`` of the PyTorch port against the JAX package's, phase
by phase, on the state after round 2 of a solve.

Both packages solve identical shards (the JAX shards read out through
``shards_from_arrays``): dense under the bucketed exchange and ragged
under the dense one (``a2a_dense``), with every kernel backend; each package
runs two rounds of its own engine and then drives its phase callables on
that state. Every output is equal, tolerance zero. Composing local ->
send -> exchange -> merge equals one round of ``make_round``, and
``fused`` exists exactly when the shards carry all three tile layouts.
"""
import dataclasses
import warnings

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402

ALL = dict(local_solver="pallas", send_backend="pallas",
           merge_backend="pallas", pallas_sweeps=2)
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
SOURCES = [0, 9, 40]


def _shards(layout, **opts):
    g = jg.rmat_graph(scale=7, edge_factor=6, seed=4)
    sj = jc.build_shards(g, 4, layout=layout, **TILE, **opts)
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return sj, tc.shards_from_arrays(fields, **static)


def _round2(sj, st, cfg):
    """Each package's carry after two rounds of its own engine."""
    ej = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg))
    cj = jc.sssp._init_carry(sj, jnp.asarray(SOURCES, jnp.int32),
                             ej.cfg, rank=None, vmapped=True)
    et = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu")
    ct = et.start(SOURCES, bucket=False)
    for _ in range(2):
        cj, ct = ej.round_fn(cj), et.round_fn(ct)
    np.testing.assert_array_equal(ct.dist.numpy(), np.asarray(cj.dist))
    return cj, ct, et


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout,exchange", [("dense", "bucket"),
                                             ("ragged", "a2a_dense")])
def test_staged_phases_match_reference(layout, exchange):
    sj, st = _shards(layout)
    cfg = dict(ALL, exchange=exchange)
    cj, ct, et = _round2(sj, st, cfg)
    fj = jc.sim_phase_fns(sj, jc.SsspConfig(**cfg))
    ft = tc.sim_phase_fns(st, tc.SsspConfig(**cfg))
    assert set(ft) == set(fj) == {"local", "send", "exchange", "merge",
                                  "fused"}
    act_j = cj.active & ~cj.done[..., None]
    act_t = ct.active & ~ct.done[..., None]
    local_t = ft["local"](ct.dist, act_t, ct.pruned, ct.tri_cursor)
    _equal(local_t, fj["local"](cj.dist, act_j, cj.pruned, cj.tri_cursor))
    dist_t, pruned_t = local_t[0], local_t[1]
    dist_j, pruned_j = (jnp.asarray(dist_t.numpy()),
                        jnp.asarray(pruned_t.numpy()))
    send_t = ft["send"](dist_t, pruned_t, ct.last_sent)
    _equal(send_t, fj["send"](dist_j, pruned_j, cj.last_sent))
    inc_t = ft["exchange"](send_t[0])
    _equal(inc_t, fj["exchange"](jnp.asarray(send_t[0].numpy())))
    merge_t = ft["merge"](dist_t, inc_t)
    _equal(merge_t, fj["merge"](dist_j, jnp.asarray(inc_t.numpy())))
    # the four phases compose to one round of make_round
    nxt = et.round_fn(ct)
    for a, b in ((merge_t[0], nxt.dist), (merge_t[1], nxt.active),
                 (send_t[1], nxt.last_sent), (pruned_t, nxt.pruned),
                 (local_t[2], nxt.tri_cursor)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_phase_matches_reference(layout):
    sj, st = _shards(layout)
    cfg = dict(round="fused", pallas_sweeps=2)
    cj, ct, _ = _round2(sj, st, cfg)
    fj = jc.sim_phase_fns(sj, jc.SsspConfig(**cfg))
    ft = tc.sim_phase_fns(st, tc.SsspConfig(**cfg))
    live_j, live_t = ~cj.done, ~ct.done
    _equal(ft["fused"](ct.dist, ct.active & live_t[..., None], live_t,
                       ct.incoming, ct.last_sent, ct.pruned),
           fj["fused"](cj.dist, cj.active & live_j[..., None], live_j,
                       cj.incoming, cj.last_sent, cj.pruned))


@pytest.mark.parametrize("opts", [dict(relax_layout=False),
                                  dict(comm_layout=False)],
                         ids=["no-relax", "no-comm"])
def test_fused_only_with_every_layout(opts):
    """Without a layout there is no ``fused`` callable, in either
    package; the staged ones fall back and still agree."""
    sj, st = _shards("dense", **opts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        fj = jc.sim_phase_fns(sj, jc.SsspConfig(**ALL))
        ft = tc.sim_phase_fns(st, tc.SsspConfig(**ALL))
        assert set(ft) == set(fj) == {"local", "send", "exchange", "merge"}
        cj, ct, _ = _round2(sj, st, ALL)
        _equal(ft["send"](ct.dist, ct.pruned, ct.last_sent),
               fj["send"](cj.dist, cj.pruned, cj.last_sent))
