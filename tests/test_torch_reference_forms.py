"""The reference's public calls, made in the reference's own form, in both
packages (tolerance zero), and a static guard over every public signature.

Each of the five surface repairs (ROADMAP.md, Queue 3, items 3.1-3.5)
is one parametrised test:
- the fused round's per-shard entry points (``fused_round_pallas``,
  ``fused_round_rescue``, ``fused_round_ref``): shard 0 of a small R-MAT
  at K = 3, dense and ragged layouts, bucket and dense incoming, against
  the JAX kernels in interpret mode;
- the fault injector's per-shard form (``init_state`` with no
  ``n_parts``, ``inject`` with one key): three rounds under one plan of
  each regime;
- ``materialize(defs, key, default_dtype)``, the type passed third;
- ``PartitionedGraph.e_max`` / ``.n_cut_edges`` and the names
  ``repro_torch.configs`` re-exports;
- ``make_finalize(sh, cfg, comm, vmapped)`` on a carry two rounds in,
  ``SsspEngine``'s eight positional parameters, ``QueryResult``'s field
  order and ``toka2_init(rank)``.

The guard walks the public functions and methods of ``src/repro/`` and
asserts, with ``inspect.signature`` only, that the namesake in
``src/repro_torch/`` takes the reference's positional parameters in the
reference's order (its keyword-only ones by name) and requires no other.
``ALLOWED`` holds the adaptations ROADMAP.md's "Explicit omissions" names,
each with its reason.
"""
import importlib
import inspect
import pathlib

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_async_ref as aref  # noqa: E402
import repro.core as jc  # noqa: E402
import repro.core.faults as jf  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro.kernels.round as j_round  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.faults as tf  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import repro_torch.kernels.round as t_round  # noqa: E402
from repro_torch.core import prng  # noqa: E402

INF = np.float32(np.inf)
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{what} output {i}")


# ------------------------------------------------------- 3.1 fused round --

@pytest.fixture(scope="module")
def rmat_shards():
    cache = {}

    def get(layout):
        if layout not in cache:
            g = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
            sj = jc.build_shards(g, 3, layout=layout, **TILE)
            cache[layout] = (sj, aref.port_shards(sj))
        return cache[layout]
    return get


def _shard_state(sj, nq, seed):
    """Shard 0's random mid-solve state (as tests/test_fused_round.py
    makes it): dist 30% +inf, a frontier, live queries, bucket messages
    only at routed positions, last_sent +inf on invalid slots, Trishla
    masks, and a dense incoming."""
    rng = np.random.default_rng(seed)
    block = sj.block
    S, e_loc, e_cut = (sj.slot_owner.shape[1], sj.loc_src.shape[1],
                       sj.cut_src.shape[1])
    ridx = np.asarray(sj.recv_idx[0]).reshape(-1)

    def rows(shape, p_inf):
        return np.where(rng.random(shape) < p_inf, INF,
                        (rng.random(shape) * 10).astype(np.float32))
    return dict(
        dist=rows((nq, block), 0.3), front=rng.random((nq, block)) < 0.2,
        live=rng.random(nq) < 0.8,
        inc_b=np.where((ridx == block)[None], INF, rows((nq, ridx.size),
                                                         0.5)),
        inc_d=rows((nq, block), 0.5),
        last=np.where(np.asarray(sj.slot_valid[0])[None], rows((nq, S), 0.5),
                      INF),
        prn_loc=rng.random(e_loc) < 0.15, prn_cut=rng.random(e_cut) < 0.15)


def _row0(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_round_per_shard_forms(rmat_shards, layout, dense):
    """Item 3.1: the three entry points on shard 0 in the reference's
    form (``interpret=`` included), equal to JAX's, and equal to row 0 of
    the stacked bodies the solver calls."""
    sj, st = rmat_shards(layout)
    s = _shard_state(sj, 3, seed=4 + dense)
    s0 = _row0(sj)
    t0 = tuple(a[0] for a in st.relax_layout), tuple(
        a[0] for a in st.send_layout), tuple(a[0] for a in st.merge_layout)
    inc = s["inc_d"] if dense else s["inc_b"]
    kw = dict(vb=st.rx_vb, sb=st.tx_sb, n_sweeps=1)
    args_t = (_t(s["dist"]), _t(s["front"]), _t(s["live"]), _t(inc),
              _t(s["last"]), st.slot_valid[0], *t0, _t(s["prn_loc"]),
              _t(s["prn_cut"]))
    args_j = (jnp.asarray(s["dist"]), jnp.asarray(s["front"]),
              jnp.asarray(s["live"]), jnp.asarray(inc),
              jnp.asarray(s["last"]), s0.slot_valid, s0.relax_layout,
              s0.send_layout, s0.merge_layout, jnp.asarray(s["prn_loc"]),
              jnp.asarray(s["prn_cut"]))
    got = t_round.fused_round_pallas(*args_t, dense=dense, interpret=True,
                                     **kw)
    want = j_round.fused_round_pallas(*args_j, dense=dense, interpret=True,
                                      **kw)
    _equal(got, want, "fused_round_pallas")
    stacked = t_round.ops._fused_round_stacked(
        *(a[None] for a in args_t[:6]),
        *(tuple(a[:1] for a in lay) for lay in (
            st.relax_layout, st.send_layout, st.merge_layout)),
        args_t[9][None], args_t[10][None], dense=dense, **kw)
    for g, w in zip(got, stacked):
        assert torch.equal(g, w[0])
    assert bool((got[5] > 0).any())       # one sweep leaves a residual
    rest = (_t(s["last"]), st.slot_valid[0], t0[0], t0[1], _t(s["prn_loc"]),
            _t(s["prn_cut"]))
    res = t_round.fused_round_rescue(got[0], got[5], *rest, interpret=True,
                                     **kw)
    res_j = j_round.fused_round_rescue(
        want[0], want[5], jnp.asarray(s["last"]), s0.slot_valid,
        s0.relax_layout, s0.send_layout, jnp.asarray(s["prn_loc"]),
        jnp.asarray(s["prn_cut"]), interpret=True, **kw)
    _equal(res, res_j, "fused_round_rescue")
    ref = t_round.fused_round_ref(
        _t(s["dist"]), _t(s["front"]), _t(s["live"]), _t(inc),
        st.recv_idx[0], _t(s["last"]), st.slot_valid[0], st.loc_src[0],
        st.loc_dst[0], st.loc_w[0], _t(s["prn_loc"]), st.cut_src[0],
        st.cut_seg[0], st.cut_w[0], _t(s["prn_cut"]), dense=dense)
    ref_j = j_round.fused_round_ref(
        *args_j[:4], s0.recv_idx, args_j[4], s0.slot_valid, s0.loc_src,
        s0.loc_dst, s0.loc_w, args_j[9], s0.cut_src, s0.cut_seg, s0.cut_w,
        args_j[10], dense=dense)
    _equal(ref, ref_j, "fused_round_ref")
    # the rescued round reaches the oracle's fixpoint and sends
    for i, j in ((0, 0), (1, 1), (2, 2), (4, 3)):
        assert torch.equal(res[i], ref[j])


# ------------------------------------------------------ 3.2 the injector --

PLANS = {"drop": dict(drop=0.3, resend_period=4), "delay": dict(delay=0.4),
         "duplicate": dict(duplicate=0.4), "reorder": dict(reorder=0.4)}


@pytest.mark.parametrize("regime", sorted(PLANS))
def test_inject_per_shard_form(regime):
    """Item 3.2: ``init_state(plan, nq, n_msgs)`` with no ``n_parts`` and
    three rounds of ``inject(plan, incoming [K, M], d_target, state,
    key)`` with one key, as the reference's round draws it
    (``fold_in(fold_in(PRNGKey(seed), round), rank)``), equal to JAX's."""
    kw = dict(PLANS[regime], seed=5, max_delay=3)
    pt, pj = tc.FaultPlan(**kw), jc.FaultPlan(**kw)
    K, M, rank = 3, 40, 2
    st_t, st_j = tf.init_state(pt, K, M), jf.init_state(pj, K, M)
    assert tuple(st_t.queue.shape) == st_j.queue.shape == (3, K, M)
    assert tuple(st_t.unhealed.shape) == st_j.unhealed.shape == (K,)
    rng = np.random.default_rng(9)
    for rnd in range(3):
        inc = np.where(rng.random((K, M)) < 0.4, INF,
                       rng.uniform(0, 30, (K, M))).astype(np.float32)
        d_t = np.where(rng.random((K, M)) < 0.2, INF,
                       rng.uniform(0, 30, (K, M))).astype(np.float32)
        key_j = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(kw["seed"]), rnd), rank)
        key_t = prng.fold_in(prng.fold_in(prng.prng_key(kw["seed"]), rnd),
                             rank)
        want = jf.inject(pj, jnp.asarray(inc), jnp.asarray(d_t), st_j, key_j)
        got = tf.inject(pt, _t(inc), _t(d_t), st_t, key_t)
        _equal((got[0], got[1].queue, got[1].unhealed, got[2], got[3]),
               (want[0], want[1].queue, want[1].unhealed, want[2], want[3]),
               f"inject round {rnd}")
        # a key tensor draws the same as the pair of ints
        again = tf.inject(pt, _t(inc), _t(d_t), st_t,
                          torch.tensor(key_t, dtype=torch.int64))
        assert all(torch.equal(a, b) for a, b in zip(
            (got[0], got[2], got[3]), (again[0], again[2], again[3])))
        st_t, st_j = got[1], want[1]
    if regime != "drop":
        assert bool(torch.isfinite(st_t.queue).any())


# --------------------------------------------------- 3.3 materialize -----

def _ordered(bits):
    b = bits.astype(np.int64)
    sign = np.int64(1) << (8 * bits.itemsize - 1)
    return np.where(b < 0, -(b & (sign - 1)), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialize_dtype_third(dtype):
    """Item 3.3: ``materialize(defs, key, default_dtype)`` as the
    reference's launcher calls it. Every leaf's shape and type equal the
    reference's; zeros and ones leaves, and every leaf's bits against the
    port's keyword call, are exact; the normal leaves sit within the
    threefry draw's documented ulps of the reference's
    (tests/test_torch_materialize.py: 4 f32 ulp, 1 bf16 ulp)."""
    from jax.sharding import PartitionSpec as JP
    from repro.models.params import ParamDef as JDef
    from repro.models.params import materialize as jmat
    from repro_torch.models.params import ParamDef, materialize, tree_leaves
    spec = {"w": ((6, 8), "normal", None, None),
            "b": ((8,), "zeros", None, None), "g": ((8,), "ones", None, None),
            "f": ((4, 4), "normal", 0.5, "float32")}
    defs_t = {k: ParamDef(s, init=i, scale=c, dtype=d)
              for k, (s, i, c, d) in spec.items()}
    defs_j = {k: JDef(s, JP(), init=i, scale=c,
                      dtype=d and getattr(jnp, d))
              for k, (s, i, c, d) in spec.items()}
    want = jmat(defs_j, jax.random.key(3), getattr(jnp, dtype))
    got = materialize(defs_t, prng.key(3), getattr(torch, dtype),
                      device="cpu")
    kw = materialize(defs_t, prng.key(3), device="cpu",
                     default_dtype=getattr(torch, dtype))
    for (k, (_, init, _, _)), g, w, again in zip(
            sorted(spec.items()), tree_leaves(got),
            jax.tree_util.tree_leaves(want), tree_leaves(kw)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
        assert torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16
                                  else torch.int32),
                           again.view(torch.int16 if g.dtype == torch.bfloat16
                                      else torch.int32)), k
        bits = (g.view(torch.int16).numpy(), w.view(np.int16)) \
            if g.dtype == torch.bfloat16 else (g.numpy().view(np.int32),
                                               w.view(np.int32))
        ulps = int(np.abs(_ordered(bits[0]) - _ordered(bits[1])).max())
        limit = 0 if init in ("zeros", "ones") else (
            1 if g.dtype == torch.bfloat16 else 4)
        assert ulps <= limit, (k, ulps)


# --------------------------------------------------- 3.4 public names ----

@pytest.mark.parametrize("name", ["e_max", "n_cut_edges", "configs"])
def test_missing_public_names(name):
    """Item 3.4: ``PartitionedGraph.e_max`` and ``.n_cut_edges`` on the
    same graph's partition, and ``from repro_torch.configs import ARCHS,
    SHAPES, build_cell, list_cells``, equal to the reference's."""
    if name == "configs":
        import repro.configs as jcfg
        import repro_torch.configs as tcfg
        assert list(tcfg.ARCHS) == list(jcfg.ARCHS)
        assert {k: list(v) for k, v in tcfg.SHAPES.items()} == \
            {k: list(v) for k, v in jcfg.SHAPES.items()}
        assert tcfg.list_cells() == jcfg.list_cells()
        assert callable(tcfg.build_cell)
        return
    gj = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
    gt = tg.graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                              np.asarray(gj.weight), np.asarray(gj.row_ptr),
                              gj.n_vertices, gj.n_edges)
    for P in (1, 3, 8):
        want = getattr(jc.partition_1d(gj, P), name)
        got = getattr(tc.partition_1d(gt, P), name)
        assert type(got) is int and got == int(want), (P, got, want)


# ------------------------------------------------ 3.5 signature gaps -----

FINALIZE = {"staged": dict(), "fused": dict(round="fused"),
            "async": dict(exchange="async_bucket")}


@pytest.mark.parametrize("case", ["finalize-staged", "finalize-fused",
                                  "finalize-async", "engine",
                                  "query_result", "toka2_init"])
def test_signature_gaps(case):
    """Item 3.5: ``make_finalize(sh, cfg, comm, vmapped)`` (both values of
    ``vmapped``) applied to the carry after two rounds, equal to the
    reference's; ``SsspEngine(shards, cfg, backend, mesh, axis_names,
    max_bucket, result_cache, certify)`` positionally, its solve equal to
    the reference engine's; and two more found by the guard below:
    ``QueryResult`` built positionally, ``toka2_init(rank)`` of one shard."""
    sj, st, _ = aref.fixture_shards()
    srcs = [0, 7, 11]
    if case.startswith("finalize"):
        from repro.core import sssp as jsssp
        from repro_torch.core import sssp as tsssp
        cfg_kw = FINALIZE[case.split("-")[1]]
        cj, ct = jc.SsspConfig(**cfg_kw), tc.SsspConfig(**cfg_kw)
        P = st.n_parts
        carry_j = jsssp._init_carry(sj, jnp.asarray(srcs, jnp.int32), cj,
                                    rank=None, vmapped=True)
        round_j = jax.jit(jsssp._make_round(sj, cj, jsssp.SimComm(P),
                                            vmapped=True, n_parts=P))
        carry_t = tsssp.init_carry(st, srcs, ct)
        round_t = tsssp.make_round(st, ct)
        for _ in range(2):
            carry_j, carry_t = round_j(carry_j), round_t(carry_t)
        fin_j = jsssp.make_finalize(sj, cj, jsssp.SimComm(P), vmapped=True)
        for vmapped in (True, False):
            fin_t = tsssp.make_finalize(st, ct, tsssp.SimComm(P, st.device),
                                        vmapped)
            assert (fin_t is None) == (fin_j is None) == (case ==
                                                          "finalize-staged")
            if fin_t is not None:
                np.testing.assert_array_equal(
                    fin_t(carry_t).numpy(), np.asarray(fin_j(carry_j)))
        return
    if case == "engine":
        cfg_kw = dict(round="fused")
        ej = jc.SsspEngine(sj, jc.SsspConfig(**cfg_kw), "sim", None, None, 4,
                           8, False)
        et = tc.SsspEngine(st, tc.SsspConfig(**cfg_kw), "sim", None, None, 4,
                           8, False, device="cpu")
        for e in (ej, et):
            assert (e.max_bucket, e.result_cache.maxsize, e.certify) == (
                4, 8, False)
        aref.assert_results_equal(et.solve(srcs), ej.solve(srcs))
        return
    if case == "query_result":
        from repro.core.engine import QueryResult as JQ
        from repro_torch.core.engine import QueryResult as TQ
        args = (np.zeros((1, 3)), (0,), None, 1, "sim", 0.5, 0.25, True, 2,
                True, "degraded")
        for q in (JQ(*args), TQ(*args)):
            assert (q.cache_hits, q.warm_started, q.status) == (
                2, True, "degraded")
        return
    import repro.core.toka as jt
    import repro_torch.core.toka as tt
    for rank in (0, 3):
        got, want = tt.toka2_init(rank), jt.toka2_init(rank)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.shape == () and g.item() == np.asarray(w).item()


# ------------------------------------------------------- the guard --------

_SHMAP = ("the shmap builders and the collectives take the port's "
          "AxisGroup or comm, not axis names inside shard_map (ROADMAP, "
          "Explicit omissions)")
_BODIES = ("the kernel bodies take the P-stacked form and drop the TPU's "
           "eb and interpret; the per-shard wrappers in kernels/*/ops.py "
           "are the entry points (ROADMAP, Explicit omissions)")
ALLOWED = {
    "repro.compat": "shims between JAX versions; the port imports no JAX, "
                    "launch/mesh.py: use_mesh is its set_mesh (ROADMAP, "
                    "Explicit omissions)",
    "repro.launch.hlo_analysis.collective_bytes":
        "takes the record of the collectives a step issued "
        "(collectives.recording), not the HLO text of a partitioned XLA "
        "program, which a PyTorch step has not: its first argument is "
        "``trace`` (ROADMAP, Explicit omissions)",
    "repro.launch.mesh.make_host_mesh":
        "the communication backend is always the caller's, a required "
        "keyword (ROADMAP, Explicit omissions)",
    "repro.core.sssp.ShmapComm.__init__": _SHMAP,
    "repro.core.sssp.build_shmap_certificate": _SHMAP,
    "repro.core.sssp.build_shmap_solver": _SHMAP,
    "repro.core.sssp.build_shmap_solver_traced": _SHMAP,
    **{f"repro.distributed.collectives.{n}": _SHMAP for n in (
        "axis_sizes", "flat_rank", "flat_size", "pmin_named", "pmax_named",
        "psum_named", "all_reduce_min", "or_reduce", "and_reduce",
        "all_to_all_tiled", "ring_permute", "ring_permute_rev")},
    **{f"repro.kernels.{n}": _BODIES for n in (
        "relax.relax.relax_dst_tiled",
        "relax.relax.relax_dst_tiled_masked",
        "relax.relax.relax_dst_tiled_fixpoint",
        "relax.relax.relax_dst_tiled_fixpoint_batch",
        "relax.relax.relax_dst_ragged_fixpoint_batch",
        "round.round.fused_round_tiled",
        "round.round.fused_round_ragged", "send.send.send_pack_tiled",
        "send.send.send_pack_ragged", "merge.merge.merge_scatter_tiled",
        "merge.merge.merge_scatter_ragged")},
}
_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _call_params(fn, method: bool):
    """``fn``'s parameters as a caller passes them (a method's ``self``
    left out)."""
    static = isinstance(fn, staticmethod)
    f = fn.__func__ if isinstance(fn, (staticmethod, classmethod)) else fn
    params = list(inspect.signature(f).parameters.values())
    if (method and not static) or isinstance(fn, classmethod):
        params = params[1:]
    return params


def _fault(ref, port):
    """Why a call in the reference's form fails in the port, or None."""
    pvar = any(p.kind == p.VAR_POSITIONAL for p in port)
    kvar = any(p.kind == p.VAR_KEYWORD for p in port)
    rpos = [p for p in ref if p.kind in _POS]
    ppos = [p for p in port if p.kind in _POS]
    for i, r in enumerate(rpos):
        if i >= len(ppos):
            if not pvar:
                return f"positional {r.name!r} (#{i}) not taken"
        elif ppos[i].name != r.name and r.kind != r.POSITIONAL_ONLY:
            return f"position {i}: {r.name!r} is {ppos[i].name!r}"
    names = {p.name for p in port}
    for r in ref:
        if r.kind == r.KEYWORD_ONLY and r.name not in names and not kvar:
            return f"keyword {r.name!r} not taken"
    rnames = {p.name for p in ref}
    for p in port:
        if (p.default is p.empty and p.name not in rnames
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)):
            return f"the port requires {p.name!r}"
    return None


def _ref_modules():
    for f in sorted((SRC / "repro").rglob("*.py")):
        parts = f.relative_to(SRC).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts), \
            parts[-1] == "__init__"


def _public(rm, name: str, package: bool):
    """The public functions and classes of reference module ``rm``: those
    it defines, and for a package those it re-exports."""
    for attr, obj in sorted(vars(rm).items()):
        if attr.startswith("_") or not (inspect.isfunction(obj)
                                        or inspect.isclass(obj)):
            continue
        origin = getattr(obj, "__module__", "") or ""
        if origin == name or (package and origin.startswith("repro.")):
            yield attr, obj, origin


def guard_faults():
    """({name: why} of every call the port refuses, the ``ALLOWED`` keys
    that were needed)."""
    faults, used = {}, set()
    for name, package in _ref_modules():
        if name in ALLOWED:
            used.add(name)
            continue
        rm = importlib.import_module(name)
        tm = importlib.import_module(name.replace("repro", "repro_torch", 1))
        for attr, obj, origin in _public(rm, name, package):
            key = f"{origin}.{attr}"
            if key in ALLOWED:
                used.add(key)
                continue
            if not hasattr(tm, attr):
                faults[f"{name}.{attr}"] = "missing"
                continue
            tobj = getattr(tm, attr)
            if inspect.isfunction(obj):
                why = _fault(_call_params(obj, False),
                             _call_params(tobj, False))
                if why:
                    faults[key] = why
                continue
            for mattr, mobj in vars(obj).items():
                if mattr.startswith("_") and mattr != "__init__":
                    continue
                mkey = f"{key}.{mattr}"
                if mkey in ALLOWED:
                    used.add(mkey)
                    continue
                if not (
                        inspect.isfunction(mobj)
                        or isinstance(mobj, (property, staticmethod,
                                             classmethod))):
                    continue
                if not hasattr(tobj, mattr):
                    faults[mkey] = "missing"
                    continue
                if isinstance(mobj, property):
                    continue
                why = _fault(_call_params(mobj, True), _call_params(
                    inspect.getattr_static(tobj, mattr), True))
                if why:
                    faults[mkey] = why
    return faults, used


def test_signature_guard():
    """Every public function and method of the reference has a namesake in
    the port that takes the reference's call, but for ``ALLOWED``; and
    every entry of ``ALLOWED`` names a reference function, method or
    module the walk meets."""
    faults, used = guard_faults()
    assert faults == {}
    assert sorted(set(ALLOWED) - used) == []
