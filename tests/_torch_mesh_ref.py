"""Shared pieces of the sharded-LM tests (test_torch_mesh_lm.py on the
CPU, the mesh cases of test_torch_gpu.py on the card). The rank side: one
function runs a config's forward, prefill and greedy decode, loss and
gradients and one AdamW step, under a mesh of gloo ranks or (``mesh``
None) in one process, and returns numpy arrays: this rank's shards. The
test side lays the ranks' shards together. No JAX here: the spawned ranks
import only the port, and the card's tests run without JAX.
"""
import contextlib
import dataclasses

import numpy as np

AXES = ("data", "model")


def _np(t):
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------------ the test side

def smoke_cfg(arch: str, over=None):
    """``arch``'s SMOKE config of the port, with the fields of ``over``
    replaced."""
    from repro_torch.configs import registry
    return dataclasses.replace(registry._load(arch, smoke=True)[1],
                               **(over or {}))


def defs_of(arch: str, data_shards: int, over=None) -> list:
    """The port's ``ParamDef`` of every leaf of ``arch``'s SMOKE config, in
    leaf order."""
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import _leaves
    cfg = smoke_cfg(arch, over)
    return [d for _, d in _leaves(tf.param_defs(
        cfg, MeshAxes(data=("data",), data_shards=data_shards)))]


def _mesh(shape, rank):
    from repro_torch.launch.mesh import HostMesh
    return HostMesh(shape=shape, axis_names=AXES, backend="gloo", rank=rank)


def lay(parts, shape, spec, whole_shape):
    """The whole tensor from every rank's block (``spec`` over the mesh of
    ``shape``); copies of a block must agree."""
    from repro_torch.distributed.sharding import shard_ranges
    out = np.full(whole_shape, np.nan, np.float32)
    for r, part in enumerate(parts):
        sl = tuple(slice(a, b) for a, b in shard_ranges(
            whole_shape, spec, _mesh(shape, r)))
        seen = out[sl]
        assert np.all(np.isnan(seen) | (seen == part))
        out[sl] = part
    assert not np.isnan(out).any()
    return out


def rows_of(parts, shape, key, i=None):
    """A per-row result laid together over the data ranks (model rank 0's
    copy; every model rank's must equal it)."""
    d, m = shape
    got = []
    for di in range(d):
        row = [p[key] if i is None else p[key][i]
               for p in parts[di * m:(di + 1) * m]]
        for other in row[1:]:
            np.testing.assert_array_equal(other, row[0])
        got.append(row[0])
    return np.concatenate(got)


# the KV caches' placement, the reference's (src/repro/configs/
# registry.py: the decode cells' cache_spec): rows over data, the sequence
# over model, every KV head
CACHE_SPEC = (None, "data", "model", None, None)


def blocks_of(parts, shape, key, i, whole):
    """KV caches [L, B, S, Hkv, Dh] laid together from every rank's block
    of ``CACHE_SPEC`` (``local_shard``'s: its rows, its block of the
    sequence, every KV head)."""
    from repro_torch.distributed.sharding import P
    return lay([p[key][i] for p in parts], shape, P(*CACHE_SPEC),
               whole.shape)


def kv_heads_of(parts, shape, i, whole):
    """The KV heads each rank computed over the prompt in the forward,
    before the prefill hands them to the sequence blocks' owners
    (``heads``: one [B, S, hk, Dh] pair a layer), laid together from
    every rank's rows and heads [kv0, kv0 + hk) into [L, B, S, Hkv, Dh];
    where ``model`` ranks computed the same head the copies must agree
    bit for bit."""
    out = np.full(whole.shape, np.nan, np.float32)
    d, m = shape
    for r, p in enumerate(parts):
        di = r // m
        b = whole.shape[1] // d
        sl = (slice(None), slice(di * b, (di + 1) * b), slice(None),
              slice(p["kv0"], p["kv0"] + p["hk"]))
        seen = out[sl]
        part = np.stack([layer[i] for layer in p["heads"]])
        assert np.all(np.isnan(seen) | (seen == part))
        out[sl] = part
    assert not np.isnan(out).any()
    return out


def agreeing(gen, want, lasts, rel: float):
    """Each row's count of leading greedy tokens equal to ``want``'s
    ([B, T], taken from the logits ``lasts``, one [B, V] a token), held
    exact where the top-2 gap of ``lasts`` exceeds ``2 rel`` of its
    largest logit (two sets of logits each within ``rel`` of the largest
    of ``lasts`` take the same argmax there); the row's first token at a
    smaller gap that differs ends its count."""
    B, T = want.shape
    n = np.full(B, T)
    for b in range(B):
        for t in range(T):
            if gen[b, t] == want[b, t]:
                continue
            x = np.asarray(lasts[t][b], np.float32)
            top = np.sort(x)[-2:]
            gap = (top[1] - top[0]) / np.abs(x).max()
            assert gap <= 2 * rel, (
                f"row {b} token {t} differs at a top-2 gap of {gap:.3g}")
            n[b] = t
            break
    return n


def moe_calls(parts, shape, one, n_layers: int):
    """The MoE picks of every call of a run in causal order, laid together
    over the data ranks, beside one process's and its k + 1 largest router
    probabilities: ``{"forward": [call], "serve": [prefill, decode step,
    ...], "train": [call]}``, a call ``(got, want, tops)``, each a list
    over the layers of ``[B * n, k]`` (``[B * n, k + 1]``) arrays, n tokens
    a row."""
    def calls(key, each):
        got = [rows_of(parts, shape, key, i) for i in range(len(one[key]))]
        want, tops = one[key], one[key.replace("routes", "tops")]
        return [(got[i:i + each], want[i:i + each], tops[i:i + each])
                for i in range(0, len(want), each)]
    return dict(forward=calls("routes", n_layers),
                serve=calls("prefill_routes", n_layers)
                + calls("decode_routes", n_layers),
                train=calls("train_routes", n_layers))


def held_rows(calls, B: int, groups: int, tie: float):
    """The rows of the batch [B] whose outputs a run may be held at, given
    ``calls`` (``moe_calls``' lists): every MoE call routes each of its
    ``groups`` token groups (B / groups whole rows) with one capacity, so
    a moved pick (a token's set of experts not one process's) reaches the
    tokens after it in its group (capacity keeps an expert's first tokens
    in row-major order) and its row's later positions (attention), and so
    every later call of its group. A group with a move is not held, and
    its first move in causal order, which no earlier move can have
    reached, must sit at a near tie: one process's k-th and (k+1)-th
    probabilities of that token within ``tie`` of the k-th. A reorder
    within the top-k moves no token's experts and is allowed."""
    rows = B // groups
    held = np.ones(B, bool)
    for g in range(groups):
        for got, want, tops in calls:
            first = None
            for layer, (a, w) in enumerate(zip(got, want)):
                n = a.shape[0] // B
                sl = slice(g * rows * n, (g + 1) * rows * n)
                moved = np.nonzero((np.sort(a[sl], -1)
                                    != np.sort(w[sl], -1)).any(-1))[0]
                if len(moved) and (first is None or moved[0] < first[0]):
                    first = (moved[0] + g * rows * n, layer)
            if first is None:
                continue
            t, layer = first
            top = tops[layer][t]
            k = got[layer].shape[1]
            gap = (top[k - 1] - top[k]) / top[k - 1]
            assert gap <= tie, (f"token {t}'s experts at MoE layer {layer} "
                                f"moved at a gap of {gap:.3g}, past {tie}")
            held[g * rows:(g + 1) * rows] = False
            break
    return held


def _close(got, want, rel: float):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if want.size:
        err = np.abs(got - want).max()
        assert err <= rel * np.abs(want).max(), (
            f"{err:.3g} apart, past {rel} of the largest "
            f"{np.abs(want).max():.3g}")


def check_bf16(parts, shape, one, refs, job: dict, rel: float) -> dict:
    """A bfloat16 run's rank results ``parts`` on the mesh of ``shape``
    against each result of ``refs`` (the one-process run ``one`` and any
    other of the same keys), within ``rel`` of the largest value of each
    tensor: the forward's logits and caches at the rows ``held_rows`` keeps
    (its aux loss where it keeps every row); the greedy tokens of the
    serving rows it keeps by ``agreeing`` (a token exact where the
    reference's top-2 gap exceeds ``2 rel``), and while a row's tokens
    agree its last logits and its caches; the losses and the gradient
    norm; every gradient where the train step's routing kept every row (a
    moved pick reaches every leaf's gradient through its tokens, and the
    embedding's rows of those tokens wholly). Returns the masks of the
    rows held and whether the gradients were."""
    from repro_torch.distributed.sharding import MeshAxes, P
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import _leaves
    cfg = smoke_cfg(job["arch"], job.get("over"))
    B, G, tie = one["gen"].shape[0], job["data_shards"], 2 * rel
    calls = (moe_calls(parts, shape, one, cfg.n_layers) if cfg.moe
             else dict(forward=[], serve=[], train=[]))
    fwd = held_rows(calls["forward"], B, G, tie)
    srv = held_rows(calls["serve"], B, G, tie)
    trained = bool(held_rows(calls["train"], B, G, tie).all())
    print(f"{cfg.name} on {shape}: rows held in the forward {fwd}, in "
          f"serving {srv}; gradients held {trained}")
    logits = lay([p["logits"] for p in parts], shape,
                 P("data", None, "model"), one["logits"].shape)
    kv = [blocks_of(parts, shape, "kv", i, one["kv"][i]) for i in range(2)]
    gen = rows_of(parts, shape, "gen")[srv]
    lasts = [rows_of(parts, shape, "lasts", i)[srv]
             for i in range(len(one["lasts"]))]
    caches = [blocks_of(parts, shape, "caches", i, one["caches"][i])[:, srv]
              for i in range(2)]
    P_ = caches[0].shape[2] - job["gen"]
    defs = _leaves(tf.param_defs(cfg, MeshAxes(data=("data",),
                                               data_shards=G)))
    grads = [lay([p["grads"][i] for p in parts], shape, d.pspec, d.shape)
             for i, (_, d) in enumerate(defs)]
    for w in refs:
        _close(logits[fwd], np.asarray(w["logits"])[fwd], rel)
        for i in range(2):
            _close(kv[i][:, fwd], np.asarray(w["kv"][i])[:, fwd], rel)
        for p in parts:
            if fwd.all():
                assert abs(p["aux"] - w["aux"]) <= rel * abs(w["aux"])
            for key in ("loss", "step_loss", "grad_norm"):
                assert abs(p[key] - w[key]) <= rel * abs(w[key]), key
        want_lasts = [np.asarray(x)[srv] for x in w["lasts"]]
        n = agreeing(gen, np.asarray(w["gen"])[srv], want_lasts, rel)
        for i, last in enumerate(lasts):
            _close(last[n >= i], want_lasts[i][n >= i], rel)
        for i in range(2):
            want = np.asarray(w["caches"][i])[:, srv]
            for b in range(len(n)):
                _close(caches[i][:, b, :P_ + n[b]],
                       want[:, b, :P_ + n[b]], rel)
        for g, wg in zip(grads, w["grads"], strict=True):
            if trained:
                _close(g, wg, rel)
    return dict(forward=fwd, serve=srv, trained=trained)


# ------------------------------------------------------------ the rank side

@contextlib.contextmanager
def routing(moe):
    """Within the block, every ``moe.top_k`` call (one a MoE layer) hands
    its expert ids ``[T, k]`` and its ``k + 1`` largest router
    probabilities ``[T, k + 1]`` to the two lists this yields, in call
    order."""
    real = moe.top_k
    routes, tops = [], []

    def top_k(probs, k):
        vals, idx = real(probs, k)
        routes.append(idx.cpu())
        tops.append(probs.detach().float().topk(k + 1, dim=-1).values.cpu())
        return vals, idx

    moe.top_k = top_k
    try:
        yield routes, tops
    finally:
        moe.top_k = real


def lm_job(mesh, job: dict) -> dict:
    """``job``: ``arch`` (a SMOKE config; ``over``, fields to replace),
    ``data_shards``, ``seed``,
    ``tokens`` / ``labels`` [B, S] and ``prompt`` [B, P] int32, ``gen``
    (decode steps), ``attn_impl``, ``device`` (the CPU by default). Every
    array of the result is this rank's block (its rows of the batch, its
    vocabulary block of the logits, its block of the caches' sequence,
    its shards of the parameters); ``coords`` and ``kv0`` say where it
    sits; ``multi_logits`` / ``multi_caches`` are a forward of three
    tokens into the grown caches at the prompt's end; ``heads`` holds the
    KV heads the forward computed a layer
    before the hand-over to the sequence blocks (``kv0``, ``hk``);
    ``grown`` what ``grow_caches`` gets wrong (``grow_cases``);
    ``launches`` counts the kernels the forward and the prefill
    launched."""
    import torch

    from repro_torch.core import prng
    from repro_torch.distributed.sharding import MeshAxes, block, placement
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(smoke_cfg(job["arch"], job.get("over")),
                              attn_impl=job.get("attn_impl", "chunked"))
    ax = MeshAxes(data=("data",), data_shards=job["data_shards"])
    dev = torch.device(job.get("device", "cpu"))
    with use_mesh(mesh):
        pl = placement(ax)
        d, di = (1, 0) if pl is None else (pl.d, pl.di)
        sm = tf._Mesh(cfg, ax)
        params = materialize(tf.param_defs(cfg, ax), prng.key(job["seed"]),
                             device=dev, default_dtype=cfg.dtype)

        def rows(a):
            lo, hi = block(a.shape[0], d, di)
            return torch.from_numpy(a[lo:hi]).to(dev)

        out = dict(coords=(0, 0) if mesh is None else mesh.coords(),
                   kv0=sm.kv0, hk=sm.hk)
        n0 = dict(build.LAUNCHES)
        heads = []
        real = tf._to_seq_blocks

        def to_seq_blocks(k, v, sm):
            heads.append((_np(k), _np(v)))
            return real(k, v, sm)

        tf._to_seq_blocks = to_seq_blocks
        try:
            with routing(moe) as (routes, tops):
                logits, kvs, aux = tf.forward(params, rows(job["tokens"]),
                                              cfg, ax)
        finally:
            tf._to_seq_blocks = real
        out.update(logits=_np(logits), kv=[_np(t) for t in kvs],
                   aux=float(aux), routes=[r.numpy() for r in routes],
                   tops=[t.numpy() for t in tops], heads=heads,
                   grown=grow_cases(mesh, ax, dev))

        prefill = tf.make_prefill_step(cfg, ax)
        serve = tf.make_serve_step(cfg, ax, donate=True)
        prompt = rows(job["prompt"])
        P = prompt.shape[1]
        with routing(moe) as (routes, tops):
            last, kvs = prefill(params, {"tokens": prompt})
        out.update(prefill_routes=[r.numpy() for r in routes],
                   prefill_tops=[t.numpy() for t in tops])
        out["launches"] = {k: n - n0.get(k, 0)
                           for k, n in build.LAUNCHES.items()
                           if n != n0.get(k, 0)}
        caches = tf.grow_caches(kvs, job["gen"], ax)
        # three tokens at once into the grown caches (the caches' rows
        # past the prompt, written where they fall; the caches left intact)
        logits3, caches3, _ = tf.forward(params, rows(job["tokens"])[:, :3],
                                         cfg, ax, caches, P)
        out.update(multi_logits=_np(logits3),
                   multi_caches=[_np(t) for t in caches3])
        tok = last.argmax(dim=-1)[:, None].to(torch.int32)
        toks, lasts = [tok], [_np(last)]
        with routing(moe) as (routes, tops):
            for i in range(job["gen"]):
                last, caches = serve(params, tok, caches, P + i)
                tok = last.argmax(dim=-1)[:, None].to(torch.int32)
                toks.append(tok)
                lasts.append(_np(last))
        out.update(gen=torch.cat(toks, 1).cpu().numpy(), lasts=lasts,
                   decode_routes=[r.numpy() for r in routes],
                   decode_tops=[t.numpy() for t in tops],
                   caches=[_np(t) for t in caches])

        batch = {"tokens": rows(job["tokens"]), "labels": rows(job["labels"])}
        cfg_t = dataclasses.replace(cfg, attn_impl="chunked")
        with routing(moe) as (routes, tops):
            loss, grads = tf._value_and_grad(params, batch, cfg_t, ax)
        out.update(train_routes=[r.numpy() for r in routes],
                   train_tops=[t.numpy() for t in tops])
        step = tf.make_train_step(cfg_t, ax, AdamWConfig())
        new, _, metrics = step(params, adamw_init(params), batch)
        out.update(loss=float(loss), grads=[_np(g) for g in tree_leaves(grads)],
                   step_loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   new=[_np(p) for p in tree_leaves(new)])
    return out


GROW = ((12, 4), (13, 1), (5, 0), (2, 9), (1, 1))   # (length, grown by)


def grow_cases(mesh, ax, dev):
    """``grow_caches`` on this rank's blocks of whole caches [2, B, S, 3,
    2] of distinct values, for each (S, n) of ``GROW``, against
    ``local_shard`` of ``F.pad`` of the whole by n. Returns the cases
    whose blocks differ (none)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.models import transformer as tf
    bad = []
    for S, n in GROW:
        whole = [torch.arange(2 * 4 * S * 6, dtype=torch.float32).reshape(
            2, 4, S, 3, 2) + 1000 * j for j in range(2)]
        if mesh is None:
            want = [F.pad(t, (0, 0, 0, 0, 0, n)) for t in whole]
            mine = whole
        else:
            want = [local_shard(F.pad(t, (0, 0, 0, 0, 0, n)),
                                P(*CACHE_SPEC), mesh) for t in whole]
            mine = [local_shard(t, P(*CACHE_SPEC), mesh) for t in whole]
        got = tf.grow_caches(tuple(t.to(dev) for t in mine), n, ax)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            bad.append((S, n))
    return bad


def rank_lm(mesh0, device, jobs):
    """A rank's side: each job on its own mesh shape over the same
    process group (``job["shape"]``)."""
    from repro_torch.launch.mesh import make_host_mesh
    out = []
    for job in jobs:
        mesh = make_host_mesh(job["shape"], AXES, backend="gloo")
        out.append(lm_job(mesh, job))
    return out


def rank_roundtrip(mesh, device, arch: str, seed: int):
    """Every leaf of ``param_defs`` materialized under ``mesh`` (this
    rank's shard) against ``local_shard`` of the one-process leaf, and
    ``gather_full`` of it against the one-process leaf: both bit for bit.
    Returns the names of leaves that differ (none)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import (MeshAxes, gather_full,
                                                  local_shard)
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import _leaves, materialize
    cfg = registry._load(arch, smoke=True)[1]
    ax = MeshAxes(data=("data",), data_shards=2)
    defs = tf.param_defs(cfg, ax)
    whole = materialize(defs, prng.key(seed), device="cpu")
    with use_mesh(mesh):
        mine = materialize(defs, prng.key(seed), device="cpu")
    bad = []
    for (path, d), w, s in zip(_leaves(defs), _leaves(whole), _leaves(mine),
                               strict=True):
        w, s = w[1], s[1]
        if not torch.equal(local_shard(w, d.pspec, mesh), s):
            bad.append(("shard", path))
        if not torch.equal(gather_full(s, d.pspec, mesh, d.shape), w):
            bad.append(("gather", path))
        if not torch.equal(gather_full(s, d.pspec, mesh), w):
            bad.append(("gather sizes", path))
    return bad


def rank_autograd(mesh, device):
    """The differentiable collectives on this rank of a 2 x 2 mesh:
    ``all_gather_dim`` (its backward the reduce-scatter of the whole
    gradient), ``copy_to_group`` (all-reduce backward) and
    ``reduce_from_group`` (all-reduce forward, identity backward), with
    rank-dependent inputs and cotangents whose sums the test knows."""
    import torch

    from repro_torch.distributed.collectives import (all_gather_dim,
                                                     copy_to_group,
                                                     reduce_from_group)
    r = mesh.rank
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        ag = mesh.axis_group(axes)
        x = torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2) + 10 * r
        x.requires_grad_(True)
        # 5 rows over the group: blocks of ceil(5 / n), the last shorter
        n = ag.size
        b = -(-5 // n)
        rows = min((ag.rank + 1) * b, 5) - min(ag.rank * b, 5)
        xr = x[:, :1].T.expand(rows, 3).contiguous() if rows else \
            x.new_zeros((0, 3))
        xr = xr.detach().requires_grad_(True)
        full = all_gather_dim(xr, ag, 0, 5)
        ct = torch.arange(15, dtype=torch.float32).reshape(5, 3) * (r + 1)
        (g_full,) = torch.autograd.grad((full * ct).sum(), [xr])
        y = copy_to_group(x, ag)
        (g_copy,) = torch.autograd.grad((y * (r + 1)).sum(), [x])
        z = reduce_from_group(x, ag)
        (g_red,) = torch.autograd.grad((z * (r + 1)).sum(), [x])
        out[axes] = dict(full=full.detach().numpy(), g_full=g_full.numpy(),
                         g_copy=g_copy.numpy(), z=z.detach().numpy(),
                         g_red=g_red.numpy(), rank=ag.rank, size=ag.size)
    return out


def _opt_tree(params):
    """(params, AdamWState) shaped like a train step's checkpoint, its
    ``step`` a whole 0-d leaf."""
    import torch

    from repro_torch.optim import AdamWState
    return (params, AdamWState(torch.zeros((), dtype=torch.int32), params,
                               params))


def rank_elastic(mesh, device, src: str, dst: str, arch: str):
    """Elastic restore on this rank: the one-process checkpoint of
    ``(params, opt_state)`` in ``src`` restored onto ``mesh`` (every leaf
    this rank's shard), held against ``local_shard`` of the whole, then
    saved sharded into ``dst`` for the test to restore in one process.
    Returns the leaf numbers whose shard differs (none)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import (MeshAxes, NamedSharding, P,
                                                  local_shard)
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import abstract, shardings, tree_leaves
    cfg = registry._load(arch, smoke=True)[1]
    defs = tf.param_defs(cfg, MeshAxes(data=("data",), data_shards=2))
    sh = shardings(defs, mesh)
    tree_sh = _opt_tree(sh)
    tree_sh = (sh, tree_sh[1]._replace(step=NamedSharding(mesh, P())))
    whole = restore_checkpoint(src, 1, _opt_tree(abstract(defs, cfg.dtype)),
                               device="cpu")
    with use_mesh(mesh):
        target = _opt_tree(abstract(defs, cfg.dtype))
    got, step = CheckpointManager(src).restore(target, tree_sh,
                                               device="cpu")
    bad = [i for i, (w, g, s) in enumerate(zip(
        tree_leaves(whole), tree_leaves(got), tree_leaves(tree_sh),
        strict=True)) if not torch.equal(local_shard(w, s.spec, mesh), g)]
    CheckpointManager(dst).save(step, got, tree_sh)
    return bad


def rank_world4(mesh, device, src: str, dst: str, arch: str):
    """A rank's side of the (2, 2) checks that need no model run: the
    round trips of both SMOKE configs' leaves, the autograd collectives
    and the elastic restore."""
    return dict(roundtrip={a: rank_roundtrip(mesh, device, a, 1)
                           for a in ("mistral-large-123b",
                                     "qwen3-moe-235b-a22b")},
                autograd=rank_autograd(mesh, device),
                elastic=rank_elastic(mesh, device, src, dst, arch))
