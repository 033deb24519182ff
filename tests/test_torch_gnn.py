"""The PyTorch port's GNN zoo against the JAX package: the segment-op
substrate, the MLP helper, the equivariant tables and functions, and GAT,
EGNN, MACE and GraphCast (forward, loss, every gradient, one AdamW step),
plus MACE's rotation invariance on the port.

Parameters are the JAX package's ``materialize`` of each SMOKE config,
carried to the port leaf for leaf with ``params_from_numpy``; the graph
(N = 64 nodes, 192 edges, node 0 with no in-edge, 16 padding edges with
``src = dst = N``) and the features are numpy draws from a seed. The JAX
side runs under ``jax.jit`` inside ``compat.set_mesh`` (its sharding
constraints need a mesh).

Tolerances: outputs within 1e-5 of the largest reference value (1e-4 for
MACE, whose third-order products compound rounding), the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest value, and
the parameters after one AdamW step within 1e-5 of the tree's largest
value (tests/test_torch_train.py says why the tree's).
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.models import equivariant as jeqv
from repro.models import gnn as jgnn
from repro.models.params import materialize as jax_materialize

from _torch_model_ref import reference_step

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.models import equivariant as teqv  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy, tree_leaves)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

AX = MeshAxes(data=("data",), data_shards=1)
N, E, PAD = 64, 192, 16
ARCHS = {  # arch -> (the model's name in gnn.py, output tolerance)
    "gat-cora": ("gat", 1e-5), "egnn": ("egnn", 1e-5),
    "mace": ("mace", 1e-4), "graphcast": ("graphcast", 1e-5)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (
        np.abs(want).max() if scale is None else scale))


# ------------------------------------------------------------ substrate --

def _ids(rng, n, m):
    """m segment ids in [0, n) with the sentinel n, n + 3, negatives and a
    segment left empty (n - 1)."""
    ids = rng.integers(0, n - 1, m)
    ids[::7] = n
    ids[3::11] = n + 3
    ids[5::13] = -1
    ids[6::17] = -n - 2
    return ids.astype(np.int32)


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_segment_ops_match_jax(shape):
    rng = np.random.default_rng(0)
    n, m = 9, 60
    data = rng.standard_normal((m,) + shape).astype(np.float32)
    seg = _ids(rng, n, m)
    dj, sj, dt, st = jnp.asarray(data), jnp.asarray(seg), _t(data), _t(seg)
    pairs = [(tgnn.seg_sum(dt, st, n), jgnn.seg_sum(dj, sj, n)),
             (tgnn.seg_max(dt, st, n), jgnn.seg_max(dj, sj, n)),
             (tgnn.seg_mean(dt, st, n), jgnn.seg_mean(dj, sj, n)),
             (tgnn.seg_softmax(dt, st, n), jgnn.seg_softmax(dj, sj, n))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert np.isneginf(pairs[1][0].numpy()[n - 1]).all()   # an empty segment
    # -inf scores (the GAT's padding edges) give zero weights
    dpad = np.where(seg[(...,) + (None,) * len(shape)] == n, -np.inf, data)
    np.testing.assert_allclose(
        tgnn.seg_softmax(_t(dpad), st, n).numpy(),
        np.asarray(jgnn.seg_softmax(jnp.asarray(dpad), sj, n)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_gather_nodes_matches_take_fill(shape):
    """Row gathers fill ids from n up and below -n, and wrap [-n, -1]."""
    rng = np.random.default_rng(1)
    n = 7
    h = rng.standard_normal((n,) + shape).astype(np.float32)
    idx = np.array([0, 6, 7, 9, -1, -7, -8, 3, 3], np.int32)
    np.testing.assert_array_equal(
        tgnn.gather_nodes(_t(h), _t(idx)).numpy(),
        np.asarray(jgnn.gather_nodes(jnp.asarray(h), jnp.asarray(idx))))
    for fill in (1.0, float("nan")):
        np.testing.assert_array_equal(
            tgnn.take_rows(_t(h), _t(idx.reshape(3, 3)), fill).numpy(),
            np.asarray(jnp.take(jnp.asarray(h), jnp.asarray(idx.reshape(3, 3)),
                                axis=0, mode="fill", fill_value=fill)))


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dims", [(5, 12, 7), (5, 12)])
def test_mlp_apply_matches_jax(ln, dims):
    """The layer norm with the population variance, as ``jnp.var``."""
    dims = list(dims)
    pj = jax_materialize(jgnn.mlp_defs(dims, ln=ln), jax.random.key(3))
    if ln:   # a layer norm scale other than ones
        pj["ln"] = pj["ln"] * jnp.linspace(0.5, 1.5, dims[-1])
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    assert sorted(pt) == sorted(tgnn.mlp_defs(dims, ln=ln))
    x = np.random.default_rng(2).standard_normal((11, 5)).astype(np.float32)
    n = len(dims) - 1
    _close(tgnn.mlp_apply(pt, _t(x), n), jgnn.mlp_apply(pj, jnp.asarray(x), n),
           1e-6)
    _close(tgnn.mlp_apply(pt, _t(x), n, act=torch.relu),
           jgnn.mlp_apply(pj, jnp.asarray(x), n, act=jax.nn.relu), 1e-6)


# ---------------------------------------------------------- equivariant --

def test_tp_paths_and_real_cg_equal_bit_for_bit():
    paths = tgnn._tp_paths(2)
    assert paths == jgnn._tp_paths(2) and len(paths) == 15
    for p in paths:
        got, want = teqv.real_cg(*p), jeqv.real_cg(*p)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), p


def test_spherical_harmonics_and_bessel_rbf_match_jax():
    rng = np.random.default_rng(4)
    vec = rng.standard_normal((40, 3)).astype(np.float32) * 3
    vec[0] = 0.0                                    # a self-loop
    vec[1] = [0.0, 0.0, 2.0]
    got = teqv.spherical_harmonics(_t(vec))
    want = jeqv.spherical_harmonics(jnp.asarray(vec))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for l in want:
        _close(got[l], want[l], 1e-6, scale=1.0)
    r = np.sqrt((vec * vec).sum(-1) + 1e-9).astype(np.float32)
    r[2] = 7.5                                      # past the cutoff
    for n_rbf, r_cut in ((8, 5.0), (4, 3.0)):
        _close(teqv.bessel_rbf(_t(r), n_rbf, r_cut),
               jeqv.bessel_rbf(jnp.asarray(r), n_rbf, r_cut), 1e-6,
               scale=max(1.0, float(np.abs(np.asarray(jeqv.bessel_rbf(
                   jnp.asarray(r), n_rbf, r_cut))).max())))


# --------------------------------------------------------------- models --

def graph_batch(arch, cfg, seed=0):
    """A numpy batch of ``arch`` on N nodes: E random edges into nodes 1..N-1
    (node 0 has no in-edge) and PAD padding edges (src = dst = N)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, N, E), np.full(PAD, N)])
    dst = np.concatenate([rng.integers(1, N, E), np.full(PAD, N)])
    b = dict(edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32))
    f32 = np.float32
    if arch == "gat-cora":
        b["node_feat"] = rng.standard_normal((N, cfg.d_in)).astype(f32)
        labels = rng.integers(0, cfg.n_classes, N)
        labels[::5] = -1                            # unlabeled nodes
        b["labels"] = labels.astype(np.int32)
    elif arch == "egnn":
        b["node_feat"] = rng.standard_normal((N, cfg.d_in)).astype(f32)
        b["coords"] = rng.standard_normal((N, 3)).astype(f32)
        b["labels"] = rng.standard_normal(N).astype(f32)
    elif arch == "mace":
        b["node_feat"] = rng.integers(0, 10, (N, 1)).astype(f32)
        b["coords"] = (rng.standard_normal((N, 3)) * 2).astype(f32)
        b["graph_id"] = np.repeat(np.arange(4), N // 4).astype(np.int32)
        b["graph_energy"] = rng.standard_normal(4).astype(f32)
    else:
        b["node_feat"] = rng.standard_normal((N, cfg.n_vars)).astype(f32)
        b["edge_feat"] = rng.standard_normal(
            (E + PAD, cfg.d_edge_in)).astype(f32)
        b["labels"] = rng.standard_normal((N, cfg.n_vars)).astype(f32)
    return b


def model_fns(mod, arch):
    """(param defs, forward, loss) of ``arch`` in ``mod``."""
    name = ARCHS[arch][0]
    return (getattr(mod, f"{name}_param_defs"), getattr(mod, f"{name}_forward"),
            getattr(mod, f"{name}_loss"))


@pytest.fixture(scope="module")
def reference_runs(mesh11):
    """Per arch: the JAX package's parameters, forward output, loss,
    gradients and parameters after one AdamW step, on ``graph_batch``."""
    out = {}
    for arch in ARCHS:
        cj = jax_registry._load(arch, smoke=True)[1]
        defs, fwd, loss = model_fns(jgnn, arch)
        pj = jax_materialize(defs(cj, AX), jax.random.key(5))
        bj = {k: jnp.asarray(v) for k, v in graph_batch(arch, cj).items()}

        def run(p, b, cj=cj, fwd=fwd, loss=loss):
            lv, g = jax.value_and_grad(partial(loss, cfg=cj, ax=AX))(p, b)
            return fwd(p, b, cj, AX), lv, g

        with compat.set_mesh(mesh11):
            yj, lj, gj = jax.device_get(jax.jit(run)(pj, bj))
        out[arch] = (pj, (yj, lj, gj, *reference_step(pj, gj)))
    return out


def _outputs(y):
    """A model's forward output as a flat list of arrays (MACE's dict by
    l, EGNN's (h, x))."""
    if isinstance(y, dict):
        return [y[l] for l in sorted(y)]
    return list(y) if isinstance(y, tuple) else [y]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gnn_forward_loss_grads_and_step_match_reference(arch,
                                                         reference_runs):
    pj, (yj, lj, gj, pj2, gnorm_j) = reference_runs[arch]
    ct = torch_registry._load(arch, smoke=True)[1]
    defs, fwd, loss = tgnn.MODELS[arch]
    assert (defs, fwd, loss) == model_fns(tgnn, arch)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(pt)] == [
        d.shape for d in tree_leaves(defs(ct))]
    bt = {k: _t(v) for k, v in graph_batch(arch, ct).items()}
    tol = ARCHS[arch][1]
    ys = _outputs(fwd(pt, bt, ct))
    assert len(ys) == len(_outputs(yj))
    for got, want in zip(ys, _outputs(yj)):
        _close(got, want, tol)
        assert np.isfinite(got.numpy()).all()
    lt, gt = tgnn.value_and_grad(loss, pt, bt, ct)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gleaves = jax.tree_util.tree_leaves(gj)
    assert len(tree_leaves(gt)) == len(gleaves)
    for got, want in zip(tree_leaves(gt), gleaves):
        _close(got, want, 1e-4)
    step = tgnn.make_gnn_train_step(loss, ct, AdamWConfig())
    pt2, st2, m = step(pt, adamw_init(pt), bt)
    assert int(st2.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm_j),
                               rtol=1e-5)
    scale = max(float(np.abs(a).max()) for a in pj2)
    for got, want in zip(tree_leaves(pt2), pj2, strict=True):
        _close(got, want, 1e-5, scale=scale)
    # the parameters passed in are left as they were
    for got, want in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_mace_rotation_invariance(reference_runs):
    """The port's MACE: the invariant (l = 0) features of a rotated
    molecule equal the unrotated ones (tests/test_arch_smoke.py's check,
    on the reference's parameters of the runs above)."""
    cfg = torch_registry._load("mace", smoke=True)[1]
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, reference_runs["mace"][0]), device="cpu")
    rng = np.random.default_rng(0)
    n, e = 48, 128
    coords = rng.standard_normal((n, 3)).astype(np.float32) * 2
    th = 0.9
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    base = dict(edge_src=_t(rng.integers(0, n, e).astype(np.int32)),
                edge_dst=_t(rng.integers(0, n, e).astype(np.int32)),
                node_feat=_t(rng.integers(0, 10, (n, 1)).astype(np.float32)))
    h0 = tgnn.mace_forward(params, dict(base, coords=_t(coords)), cfg)
    h1 = tgnn.mace_forward(params, dict(base, coords=_t(coords @ R.T)), cfg)
    np.testing.assert_allclose(h0[0].numpy(), h1[0].numpy(), rtol=1e-3,
                               atol=1e-4)
    # the l = 1 features turn with the molecule: not invariant
    assert not np.allclose(h0[1].numpy(), h1[1].numpy(), atol=1e-3)
