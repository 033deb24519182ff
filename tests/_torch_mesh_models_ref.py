"""Shared pieces of the sharded AutoInt and GNN tests
(test_torch_mesh_recsys_gnn.py on the CPU). The rank side: one function
runs a model's train step, serving and (AutoInt) retrieval, under a mesh
of gloo ranks or (``mesh`` None) in one process, and returns numpy arrays:
this rank's shards and rows. The inputs are numpy draws from a seed, the
same on every rank, each rank taking its block. No JAX here: the spawned
ranks import only the port.
"""
import numpy as np

from _torch_mesh_ref import AXES, _np, smoke_cfg

GNN_N, GNN_E = 256, 1024          # the launcher's graph (launch/train.py)
GNN_PAD_EVERY = 13                # every 13th edge is padding (src = N)
REC_B, REC_SERVE_B = 24, 12
N_CAND, TOP_K = 1000, 100
GNN_ARCHS = ("gat-cora", "egnn", "mace", "graphcast")


def ax_of():
    from repro_torch.distributed.sharding import MeshAxes
    return MeshAxes(data=("data",), data_shards=1)


# ------------------------------------------------------------- the inputs

def rec_inputs(cfg, seed: int = 0) -> dict:
    """AutoInt's numpy inputs: a train batch, a serve batch whose ids run
    out of range (ids >= V, ids in [-V, -1] whose wrapped row sits in
    another ``model`` block, ids below -V), a retrieval query and
    ``N_CAND`` candidates copied from 8 rows of one nonzero entry each
    (every score of a copy is exactly its row's, so ties span every rank
    boundary and the top ``TOP_K`` cut through the best row's copies)."""
    rng = np.random.default_rng(seed)
    F, L, V = cfg.n_sparse, cfg.multi_hot, cfg.total_vocab
    vpf = cfg.vocab_per_field

    def ids(B):
        raw = rng.integers(0, vpf, (B, F, L))
        return (raw + (np.arange(F) * vpf)[None, :, None]).astype(np.int32)
    serve = ids(REC_SERVE_B)
    serve[0, 0, 0] = V                 # the padding sentinel
    serve[1, 1, 0] = V + 7             # past it: padding too
    serve[2, 0, 0] = -1                # wraps to row V - 1
    serve[3, 2, 0] = -V                # wraps to row 0
    serve[4, 3, 0] = -V // 2 - 1       # wraps into the middle block
    serve[7, 4, 0] = -V - 1            # below -V: a NaN row
    rows = np.zeros((8, cfg.d_retrieval), np.float32)
    for r in range(8):
        rows[r, (5 * r) % cfg.d_retrieval] = 1.0 + 0.5 * r
    cand = rows[rng.integers(0, 8, N_CAND)]
    return dict(idx=ids(REC_B), labels=rng.integers(0, 2, REC_B).astype(
        np.int32), serve=serve, query=ids(1), cand=cand)


def gnn_inputs(arch: str, cfg, seed: int = 0) -> dict:
    """The launcher's graph (``GNN_N`` nodes, ``GNN_E`` edges, drawn as
    ``build_gnn`` draws them) with every ``GNN_PAD_EVERY``-th edge made
    padding (src = dst = N), and ``arch``'s node and edge arrays."""
    rng = np.random.default_rng(seed)
    N, E = GNN_N, GNN_E
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    src[::GNN_PAD_EVERY] = N
    dst[::GNN_PAD_EVERY] = N
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
        b["graph_id"] = np.repeat(np.arange(8), N // 8).astype(np.int32)
        b["graph_energy"] = rng.standard_normal(8).astype(f32)
    else:
        b["node_feat"] = rng.standard_normal((N, cfg.n_vars)).astype(f32)
        b["edge_feat"] = rng.standard_normal((E, cfg.d_edge_in)).astype(f32)
        b["labels"] = rng.standard_normal((N, cfg.n_vars)).astype(f32)
    return b


# ------------------------------------------------------------- the ranks

def _blocks(batch: dict, specs: dict, mesh, dev):
    """This rank's block of every array by its spec (whole with no mesh)."""
    import torch

    from repro_torch.distributed.sharding import P, local_shard
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if mesh is not None:
            t = local_shard(t, specs.get(k, P()), mesh)
        out[k] = t.contiguous().to(dev)
    return out


def _step(loss_f, params, batch, cfg, ax, step_fn):
    """(loss, grads, stepped params, metrics) of one train step."""
    from repro_torch.models.params import tree_leaves, value_and_grad
    from repro_torch.optim import adamw_init
    loss, grads = value_and_grad(loss_f, params, batch, cfg, ax)
    new, _, m = step_fn(params, adamw_init(params), batch)
    return dict(loss=float(loss), grads=[_np(g) for g in tree_leaves(grads)],
                new=[_np(p) for p in tree_leaves(new)],
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def autoint_job(mesh, job: dict) -> dict:
    """AutoInt SMOKE under ``mesh`` (None: one process): the materialized
    shards and their gathers, one train step on this rank's rows, serving
    (the out-of-range ids included) and retrieval over this rank's block
    of the candidates."""
    import torch

    from repro_torch.core import prng
    from repro_torch.distributed.sharding import P, gather_full
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import autoint as ai
    from repro_torch.models.params import _leaves, materialize, tree_leaves
    from repro_torch.optim import AdamWConfig
    cfg, ax, dev = smoke_cfg("autoint"), ax_of(), torch.device("cpu")
    x = rec_inputs(cfg, job["seed"])
    rows = {"sparse_idx": P(ax.data), "labels": P(ax.data)}
    with use_mesh(mesh):
        defs = ai.autoint_param_defs(cfg, ax)
        params = materialize(defs, prng.key(job["seed"]), device=dev)
        out = dict(coords=(0, 0) if mesh is None else mesh.coords(),
                   shards=[_np(t) for t in tree_leaves(params)],
                   table_rows=tuple(params["table"].shape))
        if mesh is not None:
            out["gathered"] = [_np(gather_full(t, d.pspec, mesh, d.shape))
                               for t, (_, d) in zip(tree_leaves(params),
                                                    _leaves(defs))]
        batch = _blocks({"sparse_idx": x["idx"], "labels": x["labels"]},
                        rows, mesh, dev)
        out.update(_step(ai.autoint_loss, params, batch, cfg, ax,
                         ai.make_autoint_train_step(cfg, ax, AdamWConfig())))
        serve = _blocks({"sparse_idx": x["serve"]}, rows, mesh, dev)
        out["serve"] = _np(ai.make_autoint_serve_step(cfg, ax)(params,
                                                               serve))
        cand = _blocks({"cand_vecs": x["cand"]},
                       {"cand_vecs": P(ax.model, None)}, mesh, dev)
        vals, idx = ai.make_retrieval_step(cfg, ax, TOP_K)(
            params, {"sparse_idx": torch.from_numpy(x["query"]), **cand})
        out.update(retr_vals=_np(vals), retr_idx=idx.numpy())
    return out


def gnn_job(mesh, job: dict) -> dict:
    """``job["arch"]`` SMOKE under ``mesh`` (None: one process) on the
    launcher's graph: the forward (this rank's node rows, the serving
    path), one train step."""
    import torch

    from repro_torch.core import prng
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import gnn
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.optim import AdamWConfig
    arch = job["arch"]
    cfg, ax, dev = smoke_cfg(arch), ax_of(), torch.device("cpu")
    rows = {k: P(ax.all) for k in ("node_feat", "coords", "labels",
                                   "graph_id", "edge_src", "edge_dst",
                                   "edge_feat")}
    defs_f, fwd, loss_f = gnn.MODELS[arch]
    with use_mesh(mesh):
        params = materialize(defs_f(cfg, ax), prng.key(job["seed"]),
                             device=dev)
        batch = _blocks(gnn_inputs(arch, cfg, job["seed"]), rows, mesh, dev)
        with torch.no_grad():
            y = fwd(params, batch, cfg, ax)
        ys = (list(y.values()) if isinstance(y, dict) else
              list(y) if isinstance(y, tuple) else [y])
        out = dict(coords=(0, 0) if mesh is None else mesh.coords(),
                   shards=[_np(t) for t in tree_leaves(params)],
                   forward=[_np(t) for t in ys])
        out.update(_step(loss_f, params, batch, cfg, ax,
                         gnn.make_gnn_train_step(loss_f, cfg, ax,
                                                 AdamWConfig())))
    return out


def launch_job(mesh, job: dict) -> dict:
    """The launcher's builders in the reference's form under ``mesh``:
    ``build_recsys(cfg, ax, 8, opt_cfg)`` or ``build_gnn(arch, cfg, ax,
    opt_cfg)`` of ``job["arch"]`` SMOKE, and the first step's loss."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    family, cfg = registry._load(job["arch"], smoke=True)
    with use_mesh(mesh):
        if family == "recsys":
            params, step, data = train.build_recsys(cfg, ax_of(), 8,
                                                    AdamWConfig(), "cpu")
        else:
            params, step, data = train.build_gnn(job["arch"], cfg, ax_of(),
                                                 AdamWConfig(), "cpu")
        _, _, m = step(params, adamw_init(params), next(iter(data)))
    return dict(loss=float(m["loss"]))


def run_job(mesh, job: dict) -> dict:
    if job.get("launch"):
        return launch_job(mesh, job)
    return (autoint_job if job["arch"] == "autoint" else gnn_job)(mesh, job)


def rank_models(mesh0, device, jobs):
    """A rank's side: each job on its own mesh shape over the same
    process group (``job["shape"]``)."""
    from repro_torch.launch.mesh import make_host_mesh
    out = []
    for job in jobs:
        mesh = make_host_mesh(job["shape"], AXES, backend="gloo")
        out.append(run_job(mesh, job))
    return out
