"""The PyTorch port's AutoInt against the JAX package: the logit, the BCE
loss, every gradient and one AdamW step, with one-hot fields and again
with bags of 3 ids holding the padding sentinel ``total_vocab`` and
negative ids (which wrap, as the reference's take does); the serve step;
and the retrieval step's values and indices against ``lax.top_k`` on
candidates with duplicated rows, so that equal scores occur and the lower
index must come first.

Parameters are the JAX package's ``materialize`` of the SMOKE config,
carried to the port with ``params_from_numpy``; ids and labels are numpy
draws from a seed. Tolerances as in tests/test_torch_gnn.py: outputs
within 1e-5 of the largest reference value, the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest value, the
parameters after a step within 1e-5 of the tree's largest value.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.models import autoint as jai
from repro.models.params import materialize as jax_materialize

from _torch_model_ref import reference_step

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.models import autoint as tai  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy, tree_leaves)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

AX = MeshAxes(data=("data",), data_shards=1)
B = 24


def _close(got, want, rel, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (
        np.abs(want).max() if scale is None else scale))


def _configs(multi_hot):
    cj = dataclasses.replace(jax_registry._load("autoint", True)[1],
                             multi_hot=multi_hot)
    ct = dataclasses.replace(torch_registry._load("autoint", True)[1],
                             multi_hot=multi_hot)
    return cj, ct


def _batch(cfg, seed=0):
    """Field-offset ids [B, F, L] (with L > 1: every fifth id the padding
    sentinel, a few -1) and 0/1 labels."""
    rng = np.random.default_rng(seed)
    F, V, L = cfg.n_sparse, cfg.vocab_per_field, cfg.multi_hot
    idx = rng.integers(0, V, (B, F, L)) + (np.arange(F) * V)[None, :, None]
    if L > 1:
        flat = idx.reshape(-1)
        flat[::5] = cfg.total_vocab
        flat[7::41] = -1
        idx[0, 0] = cfg.total_vocab                 # a field of padding only
    return {"sparse_idx": idx.astype(np.int32),
            "labels": rng.integers(0, 2, B).astype(np.int32)}


def _params(cj):
    pj = jax_materialize(jai.autoint_param_defs(cj, AX), jax.random.key(7))
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu")


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_autoint_logit_loss_grads_and_step_match_reference(multi_hot,
                                                           mesh11):
    cj, ct = _configs(multi_hot)
    pj, pt = _params(cj)
    assert [tuple(t.shape) for t in tree_leaves(pt)] == [
        d.shape for d in tree_leaves(tai.autoint_param_defs(ct))]
    b = _batch(cj)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}

    def run(p, b):
        lv, g = jax.value_and_grad(partial(jai.autoint_loss, cfg=cj,
                                           ax=AX))(p, b)
        return jai.autoint_logit(p, b, cj, AX), lv, g

    with compat.set_mesh(mesh11):
        yj, lj, gj = jax.device_get(jax.jit(run)(pj, bj))
        serve_j = np.asarray(jax.jit(jai.make_autoint_serve_step(cj, AX))(
            pj, bj))
    _close(tai.autoint_logit(pt, bt, ct), yj, 1e-5)
    _close(tai.make_autoint_serve_step(ct)(pt, bt), serve_j, 1e-5)
    pj2, gnorm_j = reference_step(pj, gj)
    step = tai.make_autoint_train_step(ct, AdamWConfig())
    pt2, st2, m = step(pt, adamw_init(pt), bt)
    np.testing.assert_allclose(float(m["loss"]), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm_j),
                               rtol=1e-5)
    lt, gt = tai.value_and_grad(tai.autoint_loss, pt, bt, ct)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for got, want in zip(tree_leaves(gt), jax.tree_util.tree_leaves(gj),
                         strict=True):
        _close(got, want, 1e-4, scale=max(float(np.abs(want).max()), 1e-30))
    scale = max(float(np.abs(a).max()) for a in pj2)
    for got, want in zip(tree_leaves(pt2), pj2, strict=True):
        _close(got, want, 1e-5, scale=scale)
    assert int(st2.step) == 1


def test_autoint_bags_sum_their_valid_rows():
    """A bag's embedding is the sum of the table rows of its ids, the
    sentinel adding nothing (a bag of sentinels embeds to zeros), an id in
    [-V, -1] wrapping to row V + id and one below -V giving NaN, as the
    reference's take does."""
    cj, ct = _configs(3)
    _, pt = _params(cj)
    V, table = ct.total_vocab, pt["table"]
    idx = torch.from_numpy(_batch(ct)["sparse_idx"])
    x = tai._embed_fields(pt, idx, ct)
    assert torch.equal(x[0, 0], torch.zeros(ct.embed_dim))
    for b, f in ((1, 0), (2, 3), (5, 4)):
        want = sum((table[int(i) % V] for i in idx[b, f] if int(i) < V),
                   torch.zeros(ct.embed_dim))
        torch.testing.assert_close(x[b, f], want, rtol=0, atol=1e-7)
    assert (idx == V).any() and (idx == -1).any()
    far = idx.clone()
    far[3, 2, 1] = -V - 1
    y = tai._embed_fields(pt, far, ct)
    assert torch.isnan(y[3, 2]).all() and not torch.isnan(y[3, 1]).any()


@pytest.mark.parametrize("top_k", [10, 100])
def test_retrieval_matches_lax_top_k_with_ties(top_k, mesh11):
    """Candidates [512, d_retrieval] drawn from 96 distinct rows, so every
    score occurs several times: the values equal within 1e-5 of the
    largest and the indices equal, ties included."""
    cj, ct = _configs(1)
    pj, pt = _params(cj)
    rng = np.random.default_rng(9)
    base = rng.standard_normal((96, cj.d_retrieval)).astype(np.float32)
    cand = base[rng.integers(0, 96, 512)]            # duplicated rows
    for q in (1, 3):
        b = _batch(cj, seed=q)
        idx = b["sparse_idx"][:q]
        with compat.set_mesh(mesh11):
            vj, ij = jax.device_get(jax.jit(jai.make_retrieval_step(
                cj, AX, top_k))(pj, {"sparse_idx": jnp.asarray(idx),
                                     "cand_vecs": jnp.asarray(cand)}))
        vt, it = tai.make_retrieval_step(ct, top_k)(
            pt, {"sparse_idx": torch.from_numpy(idx),
                 "cand_vecs": torch.from_numpy(cand)})
        assert it.dtype == torch.int32
        _close(vt, vj, 1e-5)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        # ties occur among the top k: equal values at distinct indices
        v = vt.numpy()
        assert (np.diff(v, axis=-1) == 0).any()
