"""The fused round of the PyTorch port against the JAX package's.

Kernel level: the port's stacked ``_fused_round_stacked`` (on the CPU,
the plain versions of kernels 7 and 8) against the JAX one in interpret
mode, shard by shard, on random mid-solve states that honour the carry
contracts, for dense and ragged layouts, bucket and dense incoming, and
n_sweeps in {1, 2, 8}: all six outputs equal, and the rescue equal
wherever a residual frontier calls for it. The stacked plain oracle
``_fused_round_ref_stacked`` against the JAX one. The per-shard entry
points are held in ``tests/test_torch_reference_forms.py``. The engine level (``round="fused"`` solves) is in
``tests/test_torch_round_engine.py``, on this file's shards and helpers.
Inputs come from numpy seeds; the tolerance is zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro.kernels.round as j_round  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core import phases  # noqa: E402
from repro_torch.kernels.round.ops import (  # noqa: E402
    _fused_round_rescue_stacked as fused_round_rescue,
    _fused_round_stacked as fused_round_pallas)
from repro_torch.kernels.round.ref import (  # noqa: E402
    _fused_round_ref_stacked as fused_round_ref)

INF = np.float32(np.inf)
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
GRAPHS = {"rmat7": ("rmat_graph", dict(scale=7, edge_factor=8, seed=3), 3),
          "random": ("random_graph", dict(n=180, m=700, seed=21), 4)}



def t(a):
    return torch.from_numpy(np.array(a))


def _port_shards(sj):
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return tc.shards_from_arrays(fields, **static)


@pytest.fixture(scope="module")
def shards():
    """(JAX shards, port shards, graph) by (graph name, layout)."""
    cache = {}

    def get(name, layout):
        if (name, layout) not in cache:
            fn, kw, P = GRAPHS[name]
            g = getattr(jg, fn)(**kw)
            sj = jc.build_shards(g, P, layout=layout, **TILE)
            cache[name, layout] = (sj, _port_shards(sj), g)
        return cache[name, layout]
    return get


def _state(sj, nq, seed):
    """Random stacked mid-solve state honouring the carry contracts (as the
    JAX package's own fused-round tests make it): dist 30% +inf, frontier,
    live queries, bucket messages only at routed positions, last_sent +inf
    on invalid slots, Trishla masks, and a dense [P, K, block] incoming."""
    rng = np.random.default_rng(seed)
    P, block = sj.loc_src.shape[0], sj.block
    S, e_loc, e_cut = (sj.slot_owner.shape[1], sj.loc_src.shape[1],
                       sj.cut_src.shape[1])
    ridx = np.asarray(sj.recv_idx).reshape(P, -1)

    def rows(shape, p_inf):
        return np.where(rng.random(shape) < p_inf, INF,
                        (rng.random(shape) * 10).astype(np.float32))
    dist = rows((P, nq, block), 0.3)
    front = rng.random((P, nq, block)) < 0.2
    live = rng.random((P, nq)) < 0.8
    inc_b = np.where((ridx == block)[:, None], INF,
                     rows((P, nq, ridx.shape[1]), 0.5))
    last = np.where(np.asarray(sj.slot_valid)[:, None], rows((P, nq, S), 0.5),
                    INF)
    return dict(dist=dist, front=front, live=live, inc_b=inc_b, last=last,
                inc_d=rows((P, nq, block), 0.5),
                prn_loc=rng.random((P, e_loc)) < 0.15,
                prn_cut=rng.random((P, e_cut)) < 0.15)


def _shard(sj, p):
    return jax.tree_util.tree_map(lambda x: x[p], sj)


# ------------------------------------------------------------ kernel level --

@pytest.mark.parametrize("n_sweeps", [1, 2, 8])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fused_round_matches_pallas(shards, graph, layout, dense, n_sweeps):
    sj, st, _ = shards(graph, layout)
    s = _state(sj, 3, seed=n_sweeps + 10 * dense)
    inc = s["inc_d"] if dense else s["inc_b"]
    kw = dict(vb=st.rx_vb, sb=st.tx_sb, n_sweeps=n_sweeps)
    out = fused_round_pallas(
        t(s["dist"]), t(s["front"]), t(s["live"]), t(inc), t(s["last"]),
        st.slot_valid, st.relax_layout, st.send_layout, st.merge_layout,
        t(s["prn_loc"]), t(s["prn_cut"]), dense=dense, **kw)
    resid = out[5]
    rescued = bool((resid > 0).any())
    if rescued:
        res = fused_round_rescue(out[0], resid, t(s["last"]), st.slot_valid,
                                 st.relax_layout, st.send_layout,
                                 t(s["prn_loc"]), t(s["prn_cut"]), **kw)
    for p in range(st.n_parts):
        s0 = _shard(sj, p)
        ref = j_round.fused_round_pallas(
            *(jnp.asarray(s[k][p]) for k in ("dist", "front", "live")),
            jnp.asarray(inc[p]), jnp.asarray(s["last"][p]), s0.slot_valid,
            s0.relax_layout, s0.send_layout, s0.merge_layout,
            jnp.asarray(s["prn_loc"][p]), jnp.asarray(s["prn_cut"][p]),
            dense=dense, **kw)
        for i, (got, want) in enumerate(zip(out, ref)):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want),
                                          err_msg=f"output {i} shard {p}")
        if rescued:
            ref_r = j_round.fused_round_rescue(
                ref[0], ref[5], jnp.asarray(s["last"][p]), s0.slot_valid,
                s0.relax_layout, s0.send_layout,
                jnp.asarray(s["prn_loc"][p]), jnp.asarray(s["prn_cut"][p]),
                **kw)
            for i, (got, want) in enumerate(zip(res, ref_r)):
                np.testing.assert_array_equal(
                    got[p].numpy(), np.asarray(want),
                    err_msg=f"rescue output {i} shard {p}")
    assert int(out[3].sum()) > 0
    if n_sweeps == 1:
        assert rescued          # one in-kernel sweep leaves work behind


@pytest.mark.parametrize("dense", [False, True])
def test_fused_round_ref_matches_reference(shards, dense):
    sj, st, _ = shards("random", "dense")
    s = _state(sj, 3, seed=5 + dense)
    inc = s["inc_d"] if dense else s["inc_b"]
    ridx = st.recv_idx.reshape(st.n_parts, -1)
    out = fused_round_ref(
        t(s["dist"]), t(s["front"]), t(s["live"]), t(inc), ridx,
        t(s["last"]), st.slot_valid, st.loc_src, st.loc_dst, st.loc_w,
        t(s["prn_loc"]), st.cut_src, st.cut_seg, st.cut_w, t(s["prn_cut"]),
        dense=dense)
    for p in range(st.n_parts):
        s0 = _shard(sj, p)
        ref = j_round.fused_round_ref(
            *(jnp.asarray(s[k][p]) for k in ("dist", "front", "live")),
            jnp.asarray(inc[p]), s0.recv_idx, jnp.asarray(s["last"][p]),
            s0.slot_valid, s0.loc_src, s0.loc_dst, s0.loc_w,
            jnp.asarray(s["prn_loc"][p]), s0.cut_src, s0.cut_seg, s0.cut_w,
            jnp.asarray(s["prn_cut"][p]), dense=dense)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_round_converges_to_ref(shards, layout):
    """Kernel plus rescue reach the oracle's fixpoint and sends."""
    sj, st, _ = shards("rmat7", layout)
    s = _state(sj, 3, seed=9)
    args = (t(s["last"]), st.slot_valid, st.relax_layout, st.send_layout)
    prn = (t(s["prn_loc"]), t(s["prn_cut"]))
    out = fused_round_pallas(t(s["dist"]), t(s["front"]), t(s["live"]),
                             t(s["inc_b"]), *args, st.merge_layout, *prn,
                             vb=st.rx_vb, sb=st.tx_sb, n_sweeps=2)
    d, sv, nl, _, sends = fused_round_rescue(out[0], out[5], *args, *prn,
                                             vb=st.rx_vb, sb=st.tx_sb,
                                             n_sweeps=2)
    ref = fused_round_ref(
        t(s["dist"]), t(s["front"]), t(s["live"]), t(s["inc_b"]),
        st.recv_idx.reshape(st.n_parts, -1), t(s["last"]), st.slot_valid,
        st.loc_src, st.loc_dst, st.loc_w, prn[0], st.cut_src, st.cut_seg,
        st.cut_w, prn[1])
    for got, want in zip((d, sv, nl, sends), ref):
        assert torch.equal(got, want)


def test_fused_config_validates():
    cfg = tc.SsspConfig(round="fused")
    assert cfg.round == "fused"
    assert phases.resolve("round", "fused") == "fused"


def test_warn_once_warns_once():
    phases._WARNED.discard("test.key")
    with pytest.warns(UserWarning, match="degrading"):
        phases.warn_once("test.key", "degrading")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        phases.warn_once("test.key", "degrading")
