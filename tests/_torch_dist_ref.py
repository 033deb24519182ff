"""Shared pieces of the multi-process (``backend="shmap"``) tests of the
PyTorch port (test_torch_dist_*.py): P gloo ranks (or NCCL ranks, one a
card) started with the ``spawn`` method on a ``FileStore`` under the
test's temporary directory, with a timeout on the group so a hang fails
the test, the comparison of results (tolerance zero), and a record of
every collective a rank makes (``collective_spy``). No JAX here: the
ranks import only the port.
"""
import contextlib
import inspect
import multiprocessing as mp
import os
import pickle
import sys
import traceback

import numpy as np

COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "stale_merges", "overlap_rounds", "bytes_moved", "n_dispatches",
            "resends")
GROUP_TIMEOUT = 60        # seconds a collective may wait for its peers
RUN_TIMEOUT = 300         # seconds the whole job may take


def _worker(rank, world, fn, args, store, out, shape, axes, device,
            backend):
    try:
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(shape, axes, backend=backend,
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, timeout=GROUP_TIMEOUT)
        res = fn(mesh, device, *args)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("ok", res), f)
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, tmp_path, *args, world: int = 4, shape=None,
              axes=("data",), device: str = "cpu", meanwhile=None,
              backend: str = "gloo"):
    """Run ``fn(mesh, device, *args)`` on ``world`` ranks over ``backend``
    (spawned processes; under nccl rank r on card r; ``fn`` must be
    importable, a module-level function) and return every rank's result,
    rank order; with ``meanwhile``, a callable this process runs while the
    ranks do, (those results, its result). Raises with the first failing
    rank's traceback, or when the job outlives ``RUN_TIMEOUT``."""
    shape = (world,) if shape is None else tuple(shape)
    ctx = mp.get_context("spawn")
    # the ranks import the port from where this process does
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [os.environ.get("PYTHONPATH", "")])
    store = os.path.join(str(tmp_path), "store")
    out = os.path.join(str(tmp_path), "result")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, fn, args, store, out, shape,
                               tuple(axes), device, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    side = None
    try:
        if meanwhile is not None:
            side = meanwhile()
    finally:
        for p in procs:
            p.join(RUN_TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(world):
        path = f"{out}.{r}"
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} left no result (exit code "
                               f"{procs[r].exitcode})")
        with open(path, "rb") as f:
            status, res = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{res}")
        results.append(res)
    return results if meanwhile is None else (results, side)


def assert_same_result(got, want, counters=COUNTERS):
    """Two ``QueryResult``s (or (dist, stats) pairs) equal in distances,
    every counter and status."""
    if isinstance(got, tuple):
        (gd, gs), (wd, ws) = got, want
    else:
        gd, gs, wd, ws = got.dist, got.stats, want.dist, want.stats
        assert got.status == want.status
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd))
    for f in counters:
        np.testing.assert_array_equal(np.asarray(getattr(gs, f)),
                                      np.asarray(getattr(ws, f)), err_msg=f)


# --------------------------------------------------------------------------
# scenarios: one engine each, run the same way by the sim engine in the
# test process and by the shmap engine on every rank
# --------------------------------------------------------------------------

SOURCES = [0, 7, 11]      # tests/test_async_exchange.py's fixture sources
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")
_SHARDS: dict = {}
NOLAYOUT_GRAPH = dict(n=96, m=360, seed=7)


def shards(name: str):
    """The named test shards (P=4), built once a process: ``fixture`` is
    the reference's ``random_graph(n=180, m=720, seed=3)`` (dense, with
    Trishla), ``ragged`` an R-MAT scale-7 graph in small ragged tiles,
    ``faults`` tests/test_faults.py's ``random_graph(n=96, m=360,
    seed=7)`` without triangles, ``nolayout`` the same graph on P=2
    without any tile layout, ``parity-<P>`` the parity graph
    (``rmat_graph(scale=11)``) on P shards."""
    if name not in _SHARDS:
        import repro_torch.core as tc
        from repro_torch.graph import random_graph, rmat_graph
        if name == "fixture":
            sh = tc.build_shards(random_graph(n=180, m=720, seed=3), 4)
        elif name == "nolayout":
            sh = tc.build_shards(random_graph(**NOLAYOUT_GRAPH), 2,
                                 relax_layout=False, comm_layout=False)
        elif name.startswith("parity-"):
            sh = tc.build_shards(rmat_graph(scale=11), int(name[7:]))
        elif name == "ragged":
            sh = tc.build_shards(rmat_graph(scale=7, edge_factor=8, seed=3),
                                 4, layout="ragged", **TILE)
        else:
            sh = tc.build_shards(random_graph(n=96, m=360, seed=7), 4,
                                 enumerate_triangles=False)
        _SHARDS[name] = sh
    return _SHARDS[name]


def make_config(cfg: dict):
    import repro_torch.core as tc
    cfg = dict(cfg)
    if "faults" in cfg:
        cfg["faults"] = tc.FaultPlan(**cfg["faults"])
    return tc.SsspConfig(**cfg)


def _summary(res):
    """What a scenario compares of a ``QueryResult``: everything but the
    walls."""
    return dict(dist=res.dist, stats=res.stats, status=res.status,
                sources=res.sources, bucket_k=res.bucket_k,
                cache_hits=res.cache_hits, warm_started=res.warm_started,
                compiled=res.compiled)


def run_scenario(sc: dict, build) -> dict:
    """Run scenario ``sc`` on the engine ``build(shards, cfg, **kw)``
    returns. ``op``: ``solve`` (one batch), ``warm`` (landmarks, then the
    batch warm, twice), ``drain`` (submits, a drain, then the ``repeat``
    batch through the result LRU). Returns the results' summaries, the
    engine's accounting and the device its shards are on."""
    eng = build(shards(sc.get("shards", "fixture")), make_config(sc["cfg"]),
                **sc.get("engine", {}))
    op = sc.get("op", "solve")
    srcs = sc.get("sources", SOURCES)
    if op == "solve":
        results = [eng.solve(srcs)]
    elif op == "warm":
        eng.solve(srcs)                       # the cold bucket first
        lm = eng.precompute_landmarks(sc["landmarks"])
        results = [eng.solve(srcs), eng.solve(sc["landmarks"][:1] + srcs)]
        assert lm.dist.shape[0] == eng.shards.n_rows
    else:
        handles = [eng.submit(s) for s in srcs]
        eng.drain()
        results = [h.result() for h in handles] + [eng.solve(sc["repeat"])]
    return dict(results=[_summary(r) for r in results],
                trace_counts=dict(eng.trace_counts),
                cert_traces=eng.cert_traces,
                batches=eng.batches_served, queries=eng.queries_served,
                device=str(eng.shards.device))


def assert_same_scenario(got: dict, want: dict):
    """Two scenario runs equal in every result (distances, every counter,
    status, bucket, cache hits, warm start) and in the engines'
    accounting."""
    for g, w in zip(got["results"], want["results"], strict=True):
        np.testing.assert_array_equal(g["dist"], w["dist"])
        for f in COUNTERS:
            np.testing.assert_array_equal(np.asarray(getattr(g["stats"], f)),
                                          np.asarray(getattr(w["stats"], f)),
                                          err_msg=f)
        for k in ("status", "sources", "bucket_k", "cache_hits",
                  "warm_started", "compiled"):
            assert g[k] == w[k], k
    for k in ("trace_counts", "cert_traces", "batches", "queries"):
        assert got[k] == want[k], k


def rank_scenarios(mesh, device, scenarios):
    """A rank's side: every scenario on a shmap engine over the whole
    mesh."""
    import repro_torch.core as tc

    def build(sh, cfg, **kw):
        return tc.SsspEngine.build(sh, cfg, "shmap", mesh, mesh.axis_names,
                                   device=device, **kw)

    return [run_scenario(sc, build) for sc in scenarios]


def sim_scenario(sc: dict, device: str = "cpu") -> dict:
    import repro_torch.core as tc

    def build(sh, cfg, **kw):
        return tc.SsspEngine.build(sh, cfg, device=device, **kw)

    return run_scenario(sc, build)


def live_sources(g, k: int, seed: int):
    """``k`` vertices of ``g`` with an out-edge, drawn from ``seed``."""
    live = np.flatnonzero(np.diff(g.row_ptr.numpy()))
    return [int(s) for s in np.random.default_rng(seed).choice(live, k,
                                                                replace=False)]


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

# every collective and point-to-point call of torch.distributed (those
# this PyTorch has)
SPIED = ("all_reduce", "all_reduce_coalesced", "all_to_all_single",
         "all_to_all", "all_gather_single", "all_gather_into_tensor",
         "_all_gather_base", "all_gather", "all_gather_coalesced",
         "reduce_scatter_single", "reduce_scatter_tensor",
         "_reduce_scatter_base", "reduce_scatter", "broadcast", "reduce",
         "gather", "scatter", "barrier", "monitored_barrier", "send", "recv",
         "isend", "irecv", "batch_isend_irecv", "all_gather_object",
         "gather_object", "scatter_object_list", "broadcast_object_list",
         "send_object_list", "recv_object_list")


def _describe(name: str, fn, args, kw) -> dict:
    """One call of ``torch.distributed.<name>``: its reduction, group size,
    tensor operands (argument, shape, dtype, device, contiguous, bytes)
    and split sizes."""
    import torch
    import torch.distributed as dist
    params = inspect.signature(fn).bind(*args, **kw).arguments
    operands = []
    for arg, v in params.items():
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor):
                operands.append(dict(
                    arg=arg, shape=tuple(t.shape), dtype=str(t.dtype),
                    device=str(t.device), contiguous=t.is_contiguous(),
                    nbytes=t.numel() * t.element_size()))
    return dict(fn=name, op=str(params["op"]) if "op" in params else None,
                group_size=dist.get_world_size(params.get("group")),
                operands=operands,
                splits={k: [int(x) for x in params[k]]
                        for k in ("output_split_sizes", "input_split_sizes")
                        if params.get(k) is not None})


@contextlib.contextmanager
def collective_spy():
    """Within the block, every call of a ``SPIED`` function of
    ``torch.distributed`` is described (``_describe``) in the list this
    yields, then made as it was."""
    import torch.distributed as dist
    calls, saved = [], {}

    def spy(name, fn):
        def call(*args, **kw):
            calls.append(_describe(name, fn, args, kw))
            return fn(*args, **kw)
        return call

    for name in SPIED:
        fn = getattr(dist, name, None)
        if fn is not None:
            saved[name] = fn
            setattr(dist, name, spy(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def rank_contract(mesh, device, scenarios):
    """A rank's side of the NCCL contract: every scenario on a shmap engine
    over the whole mesh, each with the collectives it made (engine
    build, landmarks and solves)."""
    import repro_torch.core as tc

    def build(sh, cfg, **kw):
        return tc.SsspEngine.build(sh, cfg, "shmap", mesh, mesh.axis_names,
                                   device=device, **kw)

    out = []
    for sc in scenarios:
        with collective_spy() as calls:
            res = run_scenario(sc, build)
        out.append(dict(result=res, calls=calls))
    return out


def rank_collectives(mesh, device, seed):
    """A rank's side of the collective checks on a 2x2 mesh: the flat
    ranks, the rings (whole mesh and each axis), all-to-all, the
    reductions, the gather, and ``ShmapComm``'s exchanges, ring and
    transit hop on this rank's row of stacked arrays drawn from ``seed``
    (the test process holds them all and runs ``SimComm`` on the
    stack)."""
    import torch

    from repro_torch.core import ShmapComm
    from repro_torch.core.toka import Token
    from repro_torch.distributed import collectives as coll
    r = mesh.rank
    out = {}
    for axes in (("data", "model"), ("data",), ("model",)):
        ag = mesh.axis_group(axes)
        x = torch.tensor([r, 10 * r], dtype=torch.int32)
        out[axes] = dict(
            rank=coll.flat_rank(ag), size=coll.flat_size(ag),
            fwd=coll.ring_permute(x, ag).numpy(),
            bwd=coll.ring_permute_rev(x, ag).numpy(),
            a2a=coll.all_to_all_tiled(
                torch.arange(ag.size, dtype=torch.float32)[:, None]
                + 100 * r, ag).numpy(),
            min=coll.pmin_named(x.float() - 5, ag).numpy(),
            max=coll.pmax_named(x, ag).numpy(),
            sum=coll.psum_named(x, ag).numpy(),
            amin=coll.all_reduce_min(-x, ag).numpy(),
            any=coll.or_reduce(torch.tensor([r == 1, False]), ag).numpy(),
            all=coll.and_reduce(torch.tensor([r != 1, True]), ag).numpy(),
            gather=coll.all_gather_tiled(x[None], ag).numpy(),
            unchanged=x.numpy())
    ag = mesh.axis_group(mesh.axis_names)
    comm = ShmapComm(ag, torch.device(device))
    st = stacked_operands(seed, ag.size)
    row = {k: v[r:r + 1] for k, v in st.items()}
    tok = Token(*(row[f"tok_{f}"] for f in Token._fields))
    inc, fwd, bwd = comm.async_hop(row["fwd"].clone(), row["bwd"].clone())
    out["comm"] = dict(
        bucket=comm.exchange_bucket(row["bucket"]).numpy(),
        pmin=comm.exchange_pmin(row["dense"]).numpy(),
        a2a_dense=comm.exchange_a2a_dense(row["dense"]).numpy(),
        ring=tuple(t.numpy() for t in comm.ring(tok)),
        dest_dirs=comm.dest_dirs().numpy(), hop=(inc.numpy(), fwd.numpy(),
                                                 bwd.numpy()),
        all_any=comm.all_any(row["flag"]).numpy(),
        all_all=comm.all_all(row["flag"]).numpy(),
        total=comm.total(row["count"]).numpy(),
        any_global=comm.any_global(row["flag"][:, 0]).numpy(),
        gather=comm.all_gather(row["dense"]).numpy())
    return out


def stacked_operands(seed: int, P: int, K: int = 3, C: int = 5,
                     block: int = 6) -> dict:
    """Shard-stacked operands of the comm contract, from a numpy seed:
    bucketed [P, K, P, C] and dense [P, K, P, block] payloads (some
    +inf), transit buffers, a token and [P, K] flags and counts."""
    import torch
    rng = np.random.default_rng(seed)

    def payload(*shape):
        v = rng.random(shape).astype(np.float32)
        v[rng.random(shape) < 0.4] = np.inf
        return torch.from_numpy(v)

    return dict(
        bucket=payload(P, K, P, C), dense=payload(P, K, P, block),
        fwd=payload(P, K, P, block), bwd=payload(P, K, P, block),
        tok_present=torch.from_numpy(rng.random((P, K)) < 0.5),
        tok_state=torch.from_numpy(rng.integers(0, 3, (P, K), np.int32)),
        tok_count=torch.from_numpy(rng.integers(-9, 9, (P, K), np.int32)),
        tok_hops=torch.from_numpy(rng.integers(0, 9, (P, K), np.int32)),
        flag=torch.from_numpy(rng.random((P, K)) < 0.3),
        count=torch.from_numpy(rng.integers(0, 1000, (P, K), np.int32)))


def rank_wrappers(mesh, device, cfg: dict, sources):
    """A rank's side of the legacy wrappers on the fixture shards:
    ``solve_shmap``, ``solve_shmap_batch``, a ``build_shmap_solver``
    handle (the rank's own ``[1, K, block]`` rows) and ``engine_for``'s
    reuse of one engine across the calls."""
    import repro_torch.core as tc
    from repro_torch.core.engine import engine_for
    sh, c, axes = shards("fixture"), make_config(cfg), mesh.axis_names
    one = tc.solve_shmap(sh, sources[0], c, mesh, axes, device=device)
    batch = tc.solve_shmap_batch(sh, sources, c, mesh, axes, device=device)
    dist_loc, stats = tc.build_shmap_solver(sh, c, mesh, axes, sources,
                                            device=device)()
    eng = engine_for(sh, c, "shmap", mesh, axes, device=device)
    return dict(one=one, batch=batch, handle=(dist_loc.cpu().numpy(), stats),
                rank=mesh.rank, reused=eng.trace_counts == {1: 1, 4: 1,
                                                            3: 1},
                same_engine=engine_for(sh, c, "shmap", mesh, axes,
                                       device=device) is eng)


def rank_scenarios_and_wrappers(mesh, device, scenarios, cfg, sources):
    return (rank_scenarios(mesh, device, scenarios),
            rank_wrappers(mesh, device, cfg, sources))
