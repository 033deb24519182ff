"""AutoInt and the GNN zoo under a (data, model) mesh of processes: the
reference's placements (``autoint.table`` on ``P(model, None)``, the
vocab-sharded lookup, the batch over ``data``, retrieval over ``model``;
node and edge arrays in blocks over ``ax.all``), on gloo ranks on the CPU
(``tests/_torch_dist_ref.py``; the rank side in
``tests/_torch_mesh_models_ref.py``, no JAX), held against the one-process
port and against the JAX reference on one device under ``compat.set_mesh``
of a 1 x 1 mesh, on the same weights.

``autoint-smoke`` (320 table rows) and the four GNN SMOKE configs on the
launcher's graph of 256 nodes and 1,024 edges (every 13th edge padding,
``src = N``) run one train step (loss, every gradient, one AdamW step),
serving (AutoInt's scores, a GNN's forward rows) and AutoInt's retrieval,
on meshes (1, 2), (2, 1) and (2, 2), and on one mesh whose blocks do not
divide: (1, 3) for AutoInt's table rows, (3, 1) for the GNNs' nodes.
Each world size is one spawn of gloo ranks running every job of its
meshes, while this process runs the one-process port and JAX. The
launcher's ``build_recsys`` and ``build_gnn``, called in the reference's
form on (2, 2), take a first step whose loss equals the reference
launcher's.

Tolerances (float32), as tests/test_torch_mesh_lm.py holds: losses within
1e-5 relative; gradients and the parameters after one AdamW step within
1e-5 of their tree's largest value; serve scores and forward rows within
1e-5 of their largest value, NaNs in the same places (the out-of-range
ids: ids >= V are padding, ids in [-V, -1] wrap into another rank's
block, ids below -V give NaN). The materialized shards and their gathers
are bit for bit, retrieval's indices exact: the candidates are copies of
8 rows, so equal scores sit on both sides of every rank boundary and the
lower global index must win.
"""
import concurrent.futures as cf

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.launch import train as jtrain
from repro.models import autoint as jai
from repro.models import gnn as jgnn
from repro.optim import adamw as jadamw

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as dref  # noqa: E402
import _torch_mesh_models_ref as gref  # noqa: E402
import _torch_mesh_ref as mref  # noqa: E402
from repro_torch.distributed.sharding import P, block  # noqa: E402
from repro_torch.models import autoint as tai  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models.params import _leaves  # noqa: E402

F32_REL = 1e-5
AX = MeshAxes(data=("data",), data_shards=1)
ARCHS = ("autoint",) + gref.GNN_ARCHS
ODD = {"autoint": (1, 3), **{a: (3, 1) for a in gref.GNN_ARCHS}}
WORLDS = {2: [((1, 2), a) for a in ARCHS] + [((2, 1), a) for a in ARCHS],
          4: [((2, 2), a) for a in ARCHS],
          3: [(ODD[a], a) for a in ARCHS]}
CASES = [case for cases in WORLDS.values() for case in cases]
LAUNCH = ("autoint", "mace")
SEED = 0
JAX_NAME = {"gat-cora": "gat", "egnn": "egnn", "mace": "mace",
            "graphcast": "graphcast"}


def _job(shape, arch):
    return dict(arch=arch, shape=shape, seed=SEED)


def _launch_job(shape, arch):
    return dict(arch=arch, shape=shape, launch=True)


def _defs(arch):
    cfg, ax = mref.smoke_cfg(arch), gref.ax_of()
    defs = (tai.autoint_param_defs(cfg, ax) if arch == "autoint"
            else tgnn.MODELS[arch][0](cfg, ax))
    return [d for _, d in _leaves(defs)]


# ------------------------------------------------------------ the runs

def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(np.asarray(tree))


def _unflat(defs_tree, leaves):
    """The nested tree of ``defs_tree``'s shape holding ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)
    return walk(defs_tree)


def _jax_run(arch, one, mesh11):
    """The JAX reference on one device, on the one-process port's weights
    (its materialized leaves): the train step, and serving or the forward,
    and retrieval."""
    cj = jax_registry._load(arch, smoke=True)[1]
    ct = mref.smoke_cfg(arch)
    if arch == "autoint":
        dt = tai.autoint_param_defs(ct, gref.ax_of())
    else:
        dt = tgnn.MODELS[arch][0](ct, gref.ax_of())
    pj = _to_jax(_unflat(dt, one["shards"]))
    out = {}
    with compat.set_mesh(mesh11):
        if arch == "autoint":
            x = gref.rec_inputs(ct, SEED)
            batch = {"sparse_idx": jnp.asarray(x["idx"]),
                     "labels": jnp.asarray(x["labels"])}
            loss_f = jai.autoint_loss
            step = jai.make_autoint_train_step(cj, AX, jadamw.AdamWConfig())
            out["serve"] = np.asarray(jax.jit(jai.make_autoint_serve_step(
                cj, AX))(pj, {"sparse_idx": jnp.asarray(x["serve"])}))
            vals, idx = jax.jit(jai.make_retrieval_step(cj, AX, gref.TOP_K))(
                pj, {"sparse_idx": jnp.asarray(x["query"]),
                     "cand_vecs": jnp.asarray(x["cand"])})
            out.update(retr_vals=np.asarray(vals), retr_idx=np.asarray(idx))
        else:
            name = JAX_NAME[arch]
            batch = {k: jnp.asarray(v)
                     for k, v in gref.gnn_inputs(arch, ct, SEED).items()}
            loss_f = getattr(jgnn, f"{name}_loss")
            fwd = getattr(jgnn, f"{name}_forward")
            y = jax.jit(lambda p, b: fwd(p, b, cj, AX))(pj, batch)
            ys = (list(y.values()) if isinstance(y, dict) else
                  list(y) if isinstance(y, tuple) else [y])
            out["forward"] = [np.asarray(t) for t in ys]
            step = jgnn.make_gnn_train_step(loss_f, cj, AX,
                                            jadamw.AdamWConfig())
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_f(p, b, cj, AX)))(pj, batch)
        new, _, m = jax.jit(step)(pj, jadamw.adamw_init(pj), batch)
    out.update(loss=float(loss),
               grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
               step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               new=[np.asarray(p) for p in jax.tree_util.tree_leaves(new)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh11):
    """Every mesh's rank results (the world sizes spawned at once, each a
    thread's ``run_ranks``), the one-process port's and the JAX
    reference's, by (shape, arch) and arch; and the launchers' first
    losses on (2, 2), the port's ranks' and the reference's."""
    base = tmp_path_factory.mktemp("mesh_models")
    jobs = {n: [_job(*case) for case in cases] for n, cases in WORLDS.items()}
    jobs[4] += [_launch_job((2, 2), a) for a in LAUNCH]
    for n in WORLDS:
        (base / f"w{n}").mkdir()
    with cf.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {n: pool.submit(
            dref.run_ranks, gref.rank_models, base / f"w{n}", jobs[n],
            world=n, shape=jobs[n][0]["shape"], axes=mref.AXES)
            for n in WORLDS}
        one, ref, launch = {}, {}, {}
        for arch in ARCHS:
            one[arch] = gref.run_job(None, _job(None, arch))
            ref[arch] = _jax_run(arch, one[arch], mesh11)
        for arch in LAUNCH:
            launch[arch] = jtrain.main(["--arch", arch, "--smoke", "--steps",
                                        "1", "--log-every", "1"])[0]
        ranks = {}
        for n, cases in WORLDS.items():
            per_rank = futs[n].result()
            for i, case in enumerate(cases):
                ranks[case] = [r[i] for r in per_rank]
            if n == 4:
                for j, arch in enumerate(LAUNCH):
                    ranks["launch", arch] = [r[len(cases) + j]
                                             for r in per_rank]
    return ranks, one, ref, launch


def _close(got, want, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if scale is None:
        scale = np.abs(want[np.isfinite(want)]).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * scale)


def _lay(parts, shape, key, defs):
    return [mref.lay([p[key][i] for p in parts], shape, d.pspec, d.shape)
            for i, d in enumerate(defs)]


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("shape,arch", CASES)
def test_train_step_on_mesh(runs, shape, arch):
    """The loss (every rank the whole batch's), every gradient (each
    rank's shards laid together; replicated leaves equal on every rank),
    the gradient norm and the parameters after one AdamW step."""
    ranks, one, ref, _ = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    for p in parts:
        for key in ("loss", "step_loss", "grad_norm"):
            np.testing.assert_allclose(p[key], o[key], rtol=F32_REL)
            np.testing.assert_allclose(p[key], j[key], rtol=F32_REL)
    defs = _defs(arch)
    gscale = max(np.abs(g).max() for g in o["grads"])
    pscale = max(np.abs(a).max() for a in o["new"])
    for got, want_o, want_j in zip(_lay(parts, shape, "grads", defs),
                                   o["grads"], j["grads"], strict=True):
        _close(got, want_o, gscale)
        _close(got, want_j, gscale)
    for got, want_o, want_j in zip(_lay(parts, shape, "new", defs),
                                   o["new"], j["new"], strict=True):
        _close(got, want_o, pscale)
        _close(got, want_j, pscale)


@pytest.mark.parametrize("shape,arch", CASES)
def test_serving_on_mesh(runs, shape, arch):
    """AutoInt's serve scores (each data row's rows; the out-of-range ids'
    zeros, wraps and NaNs included) or a GNN's forward (each rank's node
    rows, every output of the forward)."""
    ranks, one, ref, _ = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    if arch == "autoint":
        got = mref.rows_of(parts, shape, "serve")
        assert np.isnan(got[7]) and np.isnan(o["serve"][7])
        assert np.isfinite(np.delete(got, 7)).all()
        _close(got, o["serve"])
        _close(got, j["serve"])
        return
    for i, (want_o, want_j) in enumerate(zip(o["forward"], j["forward"],
                                             strict=True)):
        spec = P(mref.AXES, *([None] * (want_o.ndim - 1)))
        got = mref.lay([p["forward"][i] for p in parts], shape, spec,
                       want_o.shape)
        _close(got, want_o)
        _close(got, want_j)


@pytest.mark.parametrize("shape", [s for s, a in CASES if a == "autoint"])
def test_retrieval_on_mesh(runs, shape):
    """Every rank's top-k over all the candidates: the indices exact
    against one process and ``lax.top_k`` (ties across rank boundaries
    resolved to the lower global index), the values within 1e-5."""
    ranks, one, ref, _ = runs
    o, j = one["autoint"], ref["autoint"]
    np.testing.assert_array_equal(o["retr_idx"], j["retr_idx"])
    m = shape[1]
    bounds = [block(gref.N_CAND, m, i)[0] for i in range(1, m)]
    top = o["retr_idx"][0]
    # the best row's copies straddle every boundary, and some lose the cut
    assert all(top.min() < b <= top.max() for b in bounds)
    assert (o["retr_vals"][0] == o["retr_vals"][0, 0]).all()
    for p in ranks[(shape, "autoint")]:
        np.testing.assert_array_equal(p["retr_idx"], o["retr_idx"])
        _close(p["retr_vals"], o["retr_vals"])
        _close(p["retr_vals"], j["retr_vals"])


@pytest.mark.parametrize("shape", [s for s, a in CASES if a == "autoint"])
def test_autoint_table_shards(runs, shape):
    """``autoint.table`` is ``P(model, None)``: a rank holds only its block
    of rows; the materialized shards and their gathers equal one
    process's draw bit for bit."""
    ranks, one, _, _ = runs
    parts, o = ranks[(shape, "autoint")], one["autoint"]
    defs = _defs("autoint")
    assert defs[-1].pspec == P("model", None)        # table, the last leaf
    V = defs[-1].shape[0]
    for p in parts:
        lo, hi = block(V, shape[1], p["coords"][1])
        assert p["table_rows"] == (hi - lo, defs[-1].shape[1])
        for got, want in zip(p["gathered"], o["shards"], strict=True):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(_lay(parts, shape, "shards", defs), o["shards"],
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", LAUNCH)
def test_launcher_builders_on_mesh(runs, arch):
    """``build_recsys(cfg, ax, batch, opt_cfg)`` and ``build_gnn(arch,
    cfg, ax, opt_cfg)`` in the reference's form on (2, 2): each rank's
    blocks of the reference's draws, a first step whose loss equals the
    reference launcher's (its own weights, within ulp of the port's)."""
    ranks, _, _, launch = runs
    for p in ranks["launch", arch]:
        np.testing.assert_allclose(p["loss"], launch[arch], rtol=F32_REL)


def test_one_process_mesh_is_no_mesh():
    """A (1, 1) host mesh runs each family exactly as no mesh does, and
    issues no collective (no process group exists)."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh
    assert not tdist.is_initialized()
    mesh = make_host_mesh(backend="gloo")
    for arch in ("autoint", "egnn"):
        a, b = gref.run_job(mesh, _job(None, arch)), gref.run_job(
            None, _job(None, arch))
        for key in ("grads", "new"):
            for x, y in zip(a[key], b[key], strict=True):
                np.testing.assert_array_equal(x, y)
        assert a["loss"] == b["loss"]
