"""The LM family under a (data, model) mesh of processes: the port's
``MeshAxes``, parameter specs, FSDP and tensor-parallel steps and
expert-parallel MoE, on gloo ranks on the CPU (spawned, a ``FileStore``,
group timeouts: ``tests/_torch_dist_ref.py``), held against the
one-process port and against the JAX reference on one device.

mistral-large-123b and qwen3-moe-235b-a22b at their SMOKE sizes run
``forward``, a prefill of 4 x 12 tokens and 4 greedy decode steps, and
one train step (``loss_fn``'s gradients, AdamW) on meshes (1, 2), (2, 1)
and (2, 2), and on one mesh each whose ``model`` size does not divide the
KV heads (qwen3 on (1, 4): 2 KV heads; mistral on (1, 3): 2 KV heads and
blocks that do not divide its widths; and mistral SMOKE with 12 query
heads over 4 KV heads on (1, 3), where a rank's query heads form no GQA
group of one size). Every rank returns its shards; the
test lays them together. The weights are ``materialize`` of
``prng.key(0)`` under the mesh; the one-process port draws the same, and
the JAX reference runs on those weights (within ulp of its own draw from
``jax.random.key(0)``, tests/test_torch_materialize.py). The MoE config
runs with ``data_shards=2`` token groups everywhere (the reference's
``G = ax.data_shards``), one process and JAX included (the JAX side on one
device through its ``gspmd`` impl: its ``shard_map`` body takes one group
a data shard).

Both configs also run in bfloat16, their published type, on (1, 2) and
(2, 2): there each rank's row-parallel and expert partials are rounded to
bfloat16 before the ``psum`` adds them in bfloat16, as the reference's
``psum`` does (kernel 12 is not on the CPU path, ``attn_impl="chunked"``;
the card's test runs it).

Tolerances: the reduction order of the all-reduces is the only licence to
leave bit equality, so float32 logits, caches, losses and gradients are
held within 1e-5 of the largest value of their tensor (the port's float32
tolerance against JAX elsewhere), the aux loss within 1e-6 a layer, and
the parameters after one AdamW step within 1e-5 of the tree's largest
value (AdamW divides each gradient by its own magnitude,
tests/test_torch_train.py). Greedy tokens and MoE routing are exact. The
materialized shards, their gathers and the elastic restore are bit for
bit. In bfloat16 the roundings of the partials move every value, so
logits, caches, losses and gradients are held within 3e-2 of the largest
value of their tensor (BF16_REL, the port's bfloat16 tolerance against
JAX). A greedy token is held exact where one process's top-2 gap exceeds
twice that share of its largest logit: two sets of logits each within
BF16_REL of one process's then take the same argmax. A row's first token
at a smaller gap ends that row's token comparison, and what the row
computes after it (its later logits, its caches past that position) is
compared only while its tokens agree. A MoE pick may move at a near tie
(one process's k-th and (k+1)-th router probabilities within twice
BF16_REL of the k-th); its token group is then left out of the
comparison of that pass, and a move in the train step's pass leaves its
gradients uncompared, the losses and gradient norm held still
(``_torch_mesh_ref.held_rows``, ``check_bf16``).
"""
import concurrent.futures as cf
import dataclasses

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as dref  # noqa: E402
import _torch_mesh_ref as mref  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.distributed.sharding import (MeshAxes as TMeshAxes,  # noqa: E402,E501
                                              P)
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import (_leaves, materialize,  # noqa: E402
                                       tree_leaves)

F32_REL = 1e-5
BF16_REL = 3e-2
AUX_ATOL = 1e-6
MISTRAL, QWEN = "mistral-large-123b", "qwen3-moe-235b-a22b"
MISTRAL16, QWEN16 = MISTRAL + ":bf16", QWEN + ":bf16"
# mistral SMOKE with 12 query heads over 4 KV heads: on a model axis of 3 a
# rank's 4 query heads read KV heads 0, 0, 0, 1 (ranks 0 and 2) or 1, 1,
# 2, 2 (rank 1), no GQA group of one size (the heads expanded, _Mesh.kv_of)
GQA3 = "mistral-large-123b:h12"
VARIANTS = {MISTRAL: (MISTRAL, None), QWEN: (QWEN, None),
            GQA3: (MISTRAL, dict(n_heads=12, n_kv_heads=4)),
            MISTRAL16: (MISTRAL, dict(dtype="bfloat16")),
            QWEN16: (QWEN, dict(dtype="bfloat16"))}
ARCHS = (MISTRAL, QWEN, GQA3, MISTRAL16, QWEN16)
BF16 = (MISTRAL16, QWEN16)
DATA_SHARDS = {MISTRAL: 1, QWEN: 2, GQA3: 1, MISTRAL16: 1, QWEN16: 2}
SEED = 0
GEN = 4
# one spawned job a world size: every mesh of that many ranks
WORLDS = {4: [((2, 2), MISTRAL), ((2, 2), QWEN), ((1, 4), QWEN),
              ((2, 2), MISTRAL16), ((2, 2), QWEN16)],
          2: [((1, 2), MISTRAL), ((1, 2), QWEN), ((2, 1), MISTRAL),
              ((2, 1), QWEN), ((1, 2), MISTRAL16), ((1, 2), QWEN16)],
          3: [((1, 3), MISTRAL), ((1, 3), GQA3)]}
CASES = [case for world in WORLDS.values() for case in world
         if case[1] not in BF16]
BF16_CASES = [case for world in WORLDS.values() for case in world
              if case[1] in BF16]


def _job(shape, name):
    rng = np.random.default_rng(7)
    V = 128
    arch, over = VARIANTS[name]
    return dict(arch=arch, over=over, shape=shape,
                data_shards=DATA_SHARDS[name],
                seed=SEED, gen=GEN,
                tokens=rng.integers(0, V, (4, 16)).astype(np.int32),
                labels=rng.integers(0, V, (4, 16)).astype(np.int32),
                prompt=rng.integers(0, V, (4, 12)).astype(np.int32))


def _cfg(name):
    arch, over = VARIANTS[name]
    return dataclasses.replace(jax_registry._load(arch, smoke=True)[1],
                               **(over or {}))


def _defs(name):
    return mref.defs_of(VARIANTS[name][0], DATA_SHARDS[name],
                        VARIANTS[name][1])


# ------------------------------------------------------------ the runs

def _jax_run(arch, pt, job):
    """The JAX reference on one device on the port's weights: forward,
    prefill and greedy decode, loss and gradients, one train step."""
    # the reference's shard_map body takes one token group a data shard,
    # so on one device its data_shards=2 groups run through its gspmd
    # impl, which computes the same function
    cj = dataclasses.replace(_cfg(arch), attn_impl="chunked",
                             moe_impl="gspmd")
    ax = MeshAxes(data=("data",), data_shards=DATA_SHARDS[arch])
    pj = _to_jax(pt)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    out = {}
    with compat.set_mesh(mesh):
        logits, kvs, aux = jax.jit(lambda p, t: jtf.forward(p, t, cj, ax))(
            pj, jnp.asarray(job["tokens"]))
        out.update(logits=np.asarray(logits),
                   kv=[np.asarray(t) for t in kvs], aux=float(aux))
        last, kvs = jax.jit(jtf.make_prefill_step(cj, ax))(
            pj, {"tokens": jnp.asarray(job["prompt"])})
        caches = tuple(jnp.pad(t, ((0, 0), (0, 0), (0, GEN), (0, 0), (0, 0)))
                       for t in kvs)
        serve = jax.jit(jtf.make_serve_step(cj, ax))
        P_ = job["prompt"].shape[1]
        lg3, c3, _ = jax.jit(lambda p, t, c: jtf.forward(
            p, t, cj, ax, caches=c, cache_pos=jnp.int32(P_)))(
            pj, jnp.asarray(job["tokens"][:, :3]), caches)
        out.update(multi_logits=np.asarray(lg3),
                   multi_caches=[np.asarray(t) for t in c3])
        tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
        toks, lasts = [tok], [np.asarray(last)]
        for i in range(GEN):
            last, caches = serve(pj, tok, caches, jnp.int32(P_ + i))
            tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
            toks.append(tok)
            lasts.append(np.asarray(last))
        out.update(gen=np.concatenate([np.asarray(t) for t in toks], 1),
                   lasts=lasts, caches=[np.asarray(t) for t in caches])
        batch = {"tokens": jnp.asarray(job["tokens"]),
                 "labels": jnp.asarray(job["labels"])}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.loss_fn(p, b, cj, ax)))(pj, batch)
        new, _, m = jax.jit(jtf.make_train_step(cj, ax, jadamw.AdamWConfig()))(
            pj, jadamw.adamw_init(pj), batch)
    out.update(loss=float(loss),
               grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
               step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               new=[np.asarray(p) for p in jax.tree_util.tree_leaves(new)])
    return out


def _to_jax(tree):
    """The port's weights as JAX arrays of the same type (a bfloat16 leaf
    through float32, which holds it exactly)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's rank results (the three world sizes spawned at once,
    each a thread's ``run_ranks``), the one-process port's and the JAX
    reference's, by (shape, arch) and arch."""
    base = tmp_path_factory.mktemp("mesh_lm")
    for n in WORLDS:
        (base / f"w{n}").mkdir()
    with cf.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {n: pool.submit(
            dref.run_ranks, mref.rank_lm, base / f"w{n}",
            [_job(*case) for case in cases], world=n, shape=cases[0][0],
            axes=mref.AXES) for n, cases in WORLDS.items()}
        one, ref = {}, {}
        for arch in ARCHS:
            job = _job(None, arch)
            one[arch] = mref.lm_job(None, job)
            cfg = mref.smoke_cfg(*VARIANTS[arch])
            pt = materialize(ttf.param_defs(cfg, TMeshAxes(
                data=("data",), data_shards=DATA_SHARDS[arch])),
                prng.key(SEED), device="cpu", default_dtype=cfg.dtype)
            ref[arch] = _jax_run(arch, pt, job)
        ranks = {}
        for n, cases in WORLDS.items():
            per_rank = futs[n].result()
            for i, case in enumerate(cases):
                ranks[case] = [r[i] for r in per_rank]
    return ranks, one, ref


def _close(got, want, rel=F32_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("shape,arch", CASES)
def test_forward_on_mesh(runs, shape, arch):
    """Logits (each rank's rows and vocabulary block), the caches (its
    block of the sequence), the KV heads each rank computed before the
    hand-over (where ``model`` ranks computed the same head, the copies
    bit for bit equal), the aux loss and the routing of every MoE
    layer."""
    ranks, one, ref = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    V = o["logits"].shape[-1]
    logits = mref.lay([p["logits"] for p in parts], shape,
                  P("data", None, "model"), (*o["logits"].shape[:2], V))
    _close(logits, o["logits"])
    _close(logits, j["logits"])
    for i in range(2):
        kv = mref.blocks_of(parts, shape, "kv", i, o["kv"][i])
        _close(kv, o["kv"][i])
        _close(kv, j["kv"][i])
        if shape[1] > 1:
            heads = mref.kv_heads_of(parts, shape, i, o["kv"][i])
            _close(heads, o["kv"][i])
    for p in parts:
        assert abs(p["aux"] - o["aux"]) <= AUX_ATOL * 2
        assert abs(p["aux"] - j["aux"]) <= AUX_ATOL * 2
    assert len(parts[0]["routes"]) == len(o["routes"])
    for i, want in enumerate(o["routes"]):
        np.testing.assert_array_equal(mref.rows_of(parts, shape, "routes", i), want)


@pytest.mark.parametrize("shape,arch", CASES)
def test_prefill_and_greedy_decode_on_mesh(runs, shape, arch):
    """The prefill's and each decode step's last logits over the whole
    vocabulary, the greedy tokens (exact), the caches after decode and
    the decode steps' routing (exact)."""
    ranks, one, ref = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    gen = mref.rows_of(parts, shape, "gen")
    np.testing.assert_array_equal(gen, o["gen"])
    np.testing.assert_array_equal(gen, j["gen"])
    for i in range(GEN + 1):
        last = mref.rows_of(parts, shape, "lasts", i)
        _close(last, o["lasts"][i])
        _close(last, j["lasts"][i])
    for i in range(2):
        c = mref.blocks_of(parts, shape, "caches", i, o["caches"][i])
        _close(c, o["caches"][i])
        _close(c, j["caches"][i])
    for i, want in enumerate(o["decode_routes"]):
        np.testing.assert_array_equal(
            mref.rows_of(parts, shape, "decode_routes", i), want)


@pytest.mark.parametrize("shape,arch", CASES)
def test_forward_of_several_tokens_into_the_caches(runs, shape, arch):
    """``forward`` of three tokens into the grown caches at the prompt's
    end (their rows land on the ranks whose blocks hold them; every
    query row attends over every rank's block): the logits and the
    caches against one process and JAX."""
    ranks, one, ref = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    logits = mref.lay([p["multi_logits"] for p in parts], shape,
                      P("data", None, "model"), o["multi_logits"].shape)
    _close(logits, o["multi_logits"])
    _close(logits, j["multi_logits"])
    for i in range(2):
        c = mref.blocks_of(parts, shape, "multi_caches", i,
                           o["multi_caches"][i])
        _close(c, o["multi_caches"][i])
        _close(c, j["multi_caches"][i])


@pytest.mark.parametrize("shape,arch", CASES + BF16_CASES)
def test_cache_blocks_are_the_reference_blocks(runs, shape, arch):
    """Every rank's caches, from the prefill and after the growth and
    decode, have the shape of its block of the reference's cache spec
    ``P(None, data, model, None, None)`` (``local_shard``'s ceil blocks,
    a trailing rank's shorter), every KV head; where the mesh's sizes
    divide the dimensions, that of JAX's ``NamedSharding.shard_shape``
    on an abstract mesh of the same axes."""
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

    from repro_torch.distributed.sharding import shard_ranges
    ranks, one, _ = runs
    parts, o = ranks[(shape, arch)], one[arch]
    amesh = AbstractMesh(shape, mref.AXES)
    for key in ("kv", "caches"):
        whole = o[key][0].shape
        divides = whole[1] % shape[0] == 0 and whole[2] % shape[1] == 0
        want_j = NamedSharding(amesh, PartitionSpec(
            *mref.CACHE_SPEC)).shard_shape(whole) if divides else None
        for r, p in enumerate(parts):
            want = tuple(hi - lo for lo, hi in shard_ranges(
                whole, P(*mref.CACHE_SPEC), mref._mesh(shape, r)))
            for i in range(2):
                assert p[key][i].shape == want
                if divides:
                    assert p[key][i].shape == tuple(want_j)


@pytest.mark.parametrize("shape,arch", CASES)
def test_grow_caches_equals_pad_then_local_shard(runs, shape, arch):
    """``grow_caches`` on every rank's blocks equals ``local_shard`` of
    ``F.pad`` of the whole caches, bit for bit, for lengths that divide
    the model axis and that do not, growths of 0 to 9 positions, and
    blocks that are empty before or after the growth
    (``_torch_mesh_ref.GROW``)."""
    ranks, _, _ = runs
    for p in ranks[(shape, arch)]:
        assert p["grown"] == []


@pytest.mark.parametrize("shape,arch", CASES)
def test_train_step_on_mesh(runs, shape, arch):
    """The loss (every rank the whole batch's), every gradient (each
    rank's shards laid together), the gradient norm and the parameters
    after one AdamW step."""
    ranks, one, ref = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    defs = _defs(arch)
    for p in parts:
        for key in ("loss", "step_loss", "grad_norm"):
            np.testing.assert_allclose(p[key], o[key], rtol=F32_REL)
            np.testing.assert_allclose(p[key], j[key], rtol=F32_REL)
    scale = max(np.abs(a).max() for a in o["new"])
    for i, d in enumerate(defs):
        g = mref.lay([p["grads"][i] for p in parts], shape, d.pspec, d.shape)
        _close(g, o["grads"][i])
        _close(g, j["grads"][i])
        new = mref.lay([p["new"][i] for p in parts], shape, d.pspec, d.shape)
        np.testing.assert_allclose(new, o["new"][i], rtol=0,
                                   atol=F32_REL * scale)
        np.testing.assert_allclose(new, j["new"][i], rtol=0,
                                   atol=F32_REL * scale)


@pytest.mark.parametrize("shape,arch", BF16_CASES)
def test_bf16_on_mesh(runs, shape, arch):
    """The configs' own type on a mesh, against the one-process port and
    JAX on one device at BF16_REL (``_torch_mesh_ref.check_bf16``): the
    forward's logits, caches and aux loss; the greedy tokens where one
    process's top-2 gap is wide (``agreeing``), and while a row's tokens
    agree its prefill's and decode steps' last logits and its caches after
    decode; the loss, the train step's loss and gradient norm, and every
    gradient. A MoE pick may move from one process's only at a near tie,
    and frees its token group from the comparison (``held_rows``)."""
    ranks, one, ref = runs
    parts, o, j = ranks[(shape, arch)], one[arch], ref[arch]
    mref.check_bf16(parts, shape, o, [o, j], _job(shape, arch), BF16_REL)


def test_reference_multidevice_lm_case_is_an_equality(runs):
    """tests/test_multidevice.py's LM case, qwen3-moe SMOKE's train step
    on a (data, model) mesh with ``data_shards=2``, asserts a finite loss;
    here the (2, 2) mesh's step equals the JAX step's on one device."""
    ranks, _, ref = runs
    parts = ranks[((2, 2), QWEN)]
    assert np.isfinite(parts[0]["step_loss"])
    np.testing.assert_allclose(parts[0]["step_loss"], ref[QWEN]["step_loss"],
                               rtol=F32_REL)
    defs = _defs(QWEN)
    scale = max(np.abs(a).max() for a in ref[QWEN]["new"])
    for i, d in enumerate(defs):
        new = mref.lay([p["new"][i] for p in parts], (2, 2), d.pspec, d.shape)
        np.testing.assert_allclose(new, ref[QWEN]["new"][i], rtol=0,
                                   atol=F32_REL * scale)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The (2, 2) mesh's round trips, autograd collectives and elastic
    restore, in one spawned job."""
    base = tmp_path_factory.mktemp("mesh_w4")
    cfg = torch_registry._load(QWEN, smoke=True)[1]
    defs = ttf.param_defs(cfg, TMeshAxes(data=("data",), data_shards=2))
    params = materialize(defs, prng.key(3), device="cpu")
    tree = mref._opt_tree(params)
    tree = (params, tree[1]._replace(step=torch.tensor(5, dtype=torch.int32)))
    CheckpointManager(str(base / "src")).save(1, tree)
    (base / "ranks").mkdir()
    res = dref.run_ranks(mref.rank_world4, base / "ranks", str(base / "src"),
                         str(base / "dst"), QWEN, world=4, shape=(2, 2),
                         axes=mref.AXES)
    return res, tree, str(base / "dst")


def test_local_shard_and_gather_full_round_trip(world4):
    """Every leaf of both configs' ``param_defs`` materialized under the
    (2, 2) mesh equals ``local_shard`` of the one-process leaf, and
    ``gather_full`` of it (with the whole shape, and with the blocks'
    sizes gathered) equals the one-process leaf, bit for bit."""
    res, _, _ = world4
    for r in res:
        assert r["roundtrip"] == {MISTRAL: [], QWEN: []}


def test_autograd_collectives(world4):
    """On each of the data, model and whole-mesh groups of (2, 2):
    ``all_gather_dim`` of 5 rows in blocks of ceil(5 / n) gives every
    rank the rows in order, and its gradient is this rank's block of the
    cotangents summed over the group (a reduce-scatter); ``copy_to_group``
    gives the gradient summed over the group; ``reduce_from_group`` sums
    the values and passes the gradient through."""
    res, _, _ = world4
    groups = {("data",): lambda r: (r % 2, r // 2),     # (key, rank in it)
              ("model",): lambda r: (r // 2, r % 2),
              ("data", "model"): lambda r: (0, r)}
    for axes, where in groups.items():
        members = {}
        for r in range(4):
            key, idx = where(r)
            members.setdefault(key, []).append((idx, r))
        for mem in members.values():
            n = len(mem)
            b = -(-5 // n)
            coef = sum(r + 1 for _, r in mem)
            rows = []
            for idx, r in sorted(mem):
                lo, hi = min(idx * b, 5), min((idx + 1) * b, 5)
                x = np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r
                rows += [x[:, 0]] * (hi - lo)
            want_full = np.stack(rows)
            ct = np.arange(15, dtype=np.float32).reshape(5, 3)
            for idx, r in mem:
                got = res[r]["autograd"][axes]
                assert got["rank"] == idx and got["size"] == n
                np.testing.assert_array_equal(got["full"], want_full)
                lo, hi = min(idx * b, 5), min((idx + 1) * b, 5)
                np.testing.assert_array_equal(got["g_full"],
                                              ct[lo:hi] * coef)
                np.testing.assert_array_equal(got["g_copy"],
                                              np.full((3, 2), coef))
                np.testing.assert_array_equal(got["g_red"],
                                              np.full((3, 2), r + 1))
                xs = sum(np.arange(6, dtype=np.float32).reshape(3, 2)
                         + 10 * q for _, q in mem)
                np.testing.assert_array_equal(got["z"], xs)


def test_elastic_restore_both_ways(world4):
    """A one-process checkpoint of qwen3-moe SMOKE's (params, AdamW
    state) restored onto (2, 2) gives each rank ``local_shard`` of every
    leaf; the ranks' sharded save restored in one process gives the saved
    arrays back, bit for bit."""
    res, tree, dst = world4
    for r in res:
        assert r["elastic"] == []
    got, step = CheckpointManager(dst).restore(tree, device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_draws_past_2_31_elements_hash_the_high_and_low_words():
    """A leaf of more than 2**31 elements (a layer-stacked weight of
    mistral-large at depth) draws element i by index: the threefry hash
    of i's high and low 32-bit words, as JAX's partitionable threefry
    counts; here against the hash on Python ints, past 2**31 and 2**32."""
    key = prng.split(prng.key(5), 3)[1]
    idx = [0, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**33 + 5, 13 * 2**30]
    got = prng.random_bits_at(key, torch.tensor(idx, dtype=torch.int64))
    k0, k1 = (int(w) for w in key)
    for i, g in zip(idx, got.tolist()):
        o0, o1 = prng.threefry2x32(k0, k1, i >> 32, i & prng.MASK)
        assert g & prng.MASK == o0 ^ o1
    # below 2**31, the same bits as the offset draw
    assert torch.equal(prng.random_bits_at(key, torch.arange(3, 40)),
                       prng.random_bits(key, (37,), 3))


@pytest.mark.parametrize("arch", [MISTRAL, QWEN])
def test_one_process_mesh_issues_no_collective(monkeypatch, arch):
    """Under the (1, 1) host mesh (``make_host_mesh`` starts no process
    group for one process) every step computes what it computes with no
    mesh, bit for bit, and no collective is called."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    def refuse(*a, **kw):
        raise AssertionError("a collective was called")

    for name in ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
                 "reduce_scatter_tensor", "barrier"):
        monkeypatch.setattr(tdist, name, refuse)
    monkeypatch.setattr(tdist, "all_gather_single", refuse, raising=False)
    monkeypatch.setattr(tdist, "reduce_scatter_single", refuse,
                        raising=False)
    mesh = make_host_mesh(backend="gloo")
    assert mesh.size == 1 and not tdist.is_initialized()
    job = _job(None, arch)
    got, want = mref.lm_job(mesh, job), mref.lm_job(None, job)
    for key in ("logits", "kv", "gen", "lasts", "caches", "grads", "new",
                "routes", "loss", "step_loss", "grad_norm"):
        a, b = got[key], want[key]
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b], strict=True):
            np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_axes_and_param_specs_match_the_reference(multi_pod):
    """``MeshAxes`` (``all``, ``batch``, ``fsdp_tp``), ``SINGLE_POD``,
    ``MULTI_POD`` and ``mesh_axes``, and ``params.specs`` of every LM
    config's ``param_defs`` under them, entry for entry the reference's
    ``PartitionSpec``s."""
    from repro.distributed import sharding as jsh
    from repro.models.params import specs as jspecs

    from repro_torch.distributed import sharding as tsh
    from repro_torch.models.params import specs as tspecs
    ja, ta = jsh.mesh_axes(multi_pod), tsh.mesh_axes(multi_pod)
    assert (ta.data, ta.model, ta.data_shards) == (ja.data, ja.model,
                                                   ja.data_shards)
    assert ta == (tsh.MULTI_POD if multi_pod else tsh.SINGLE_POD)
    assert ta.all == ja.all
    assert tuple(ta.batch(None, "x")) == tuple(ja.batch(None, "x"))
    assert tuple(ta.fsdp_tp(prefix=(None,))) == tuple(
        ja.fsdp_tp(prefix=(None,)))
    for arch in ("gemma-7b", "deepseek-7b", MISTRAL, "olmoe-1b-7b", QWEN):
        cj = jax_registry._load(arch, smoke=True)[1]
        ct = torch_registry._load(arch, smoke=True)[1]
        want = jax.tree_util.tree_flatten_with_path(
            jspecs(jtf.param_defs(cj, ja)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        got = dict(_leaves(tspecs(ttf.param_defs(ct, ta))))
        assert len(got) == len(want)
        for path, spec in want:
            key = tuple(k.key for k in path)
            assert tuple(got[key]) == tuple(spec), (arch, key)
