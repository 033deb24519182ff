"""What NCCL asks of the shmap backend's collectives, held on 4 gloo CPU
ranks (one spawn for the whole matrix): every exchange staged and fused,
toka1-3, the drop fault plan, the landmark warm start and ragged shards.
For each scenario every ``torch.distributed`` call a rank makes (engine
build, landmarks, solves) is recorded (``_torch_dist_ref.collective_spy``)
and must be what NCCL takes:

- every rank makes the same sequence: kind, reduction, operand bytes and
  group size (NCCL hangs on a mismatch where gloo may raise or cope);
- every operand is contiguous, on the engine's device, and of a dtype
  NCCL reduces as gloo does (no ``bool``: NCCL sums it as a max);
- an all-to-all's split sizes add up to its operands' rows, or, without
  splits, its rows divide by the group size.

The results equal the sim engine's bit for bit, so the spy changes
nothing.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as ref  # noqa: E402

NCCL_DTYPES = {"torch.float16", "torch.bfloat16", "torch.float32",
               "torch.float64", "torch.int8", "torch.uint8", "torch.int32",
               "torch.int64"}
EXCHANGES = {"bucket": {}, "pmin": {}, "a2a_dense": {}, "async": {},
             "async_bucket": dict(async_lag=2), "async_ppermute": {}}
SCENARIOS = {
    **{f"{ex}-staged": dict(cfg=dict(ref.ALL_KERNELS, exchange=ex, **kw))
       for ex, kw in EXCHANGES.items()},
    **{f"{ex}-fused": dict(cfg=dict(round="fused", exchange=ex, **kw))
       for ex, kw in EXCHANGES.items()},
    **{f"{toka}-{ex}": dict(cfg=dict(ref.ALL_KERNELS, exchange=ex,
                                     toka=toka))
       for toka in ("toka1", "toka2", "toka3")
       for ex in ("bucket", "async_ppermute")},
    "drop-staged": dict(shards="faults", cfg=dict(
        ref.ALL_KERNELS, faults=dict(drop=0.3, seed=0, resend_period=4))),
    "drop-fused-toka3": dict(shards="faults", cfg=dict(
        round="fused", toka="toka3",
        faults=dict(drop=0.3, seed=0, resend_period=4))),
    "landmark-warm": dict(op="warm", landmarks=[3, 60, 120],
                          cfg=dict(ref.ALL_KERNELS, warm_start="landmark")),
    "ragged-bucket": dict(shards="ragged", sources=[1, 9, 40],
                          cfg=dict(ref.ALL_KERNELS)),
    "ragged-async_ppermute-fused": dict(
        shards="ragged", sources=[1, 9, 40],
        cfg=dict(round="fused", exchange="async_ppermute")),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario on 4 ranks, with each rank's collectives, and on the
    sim engine, solved while the ranks run."""
    return ref.run_ranks(
        ref.rank_contract, tmp_path_factory.mktemp("nccl_contract"),
        list(SCENARIOS.values()), world=4,
        meanwhile=lambda: [ref.sim_scenario(sc) for sc in SCENARIOS.values()])


def _signature(call: dict):
    return (call["fn"], call["op"], call["group_size"],
            tuple(o["nbytes"] for o in call["operands"]))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_collectives_fit_nccl(ranks, name):
    per_ranks, sims = ranks
    i = list(SCENARIOS).index(name)
    seqs = [per_rank[i]["calls"] for per_rank in per_ranks]
    assert seqs[0], "the solve made no collective"
    want = [_signature(c) for c in seqs[0]]
    for r, seq in enumerate(seqs):
        got = [_signature(c) for c in seq]
        assert got == want, f"rank {r}'s collectives differ from rank 0's"
        device = per_ranks[r][i]["result"]["device"]
        for k, call in enumerate(seq):
            where = f"rank {r}, call {k} ({call['fn']})"
            for o in call["operands"]:
                assert o["contiguous"], f"{where}: {o['arg']} not contiguous"
                assert o["device"] == device, f"{where}: {o['arg']} on " \
                    f"{o['device']}, the engine on {device}"
                assert o["dtype"] in NCCL_DTYPES, f"{where}: {o['arg']} " \
                    f"is {o['dtype']}"
            if call["fn"] == "all_to_all_single":
                rows = {o["arg"]: o["shape"][0] for o in call["operands"]}
                for key, arg in (("output_split_sizes", "output"),
                                 ("input_split_sizes", "input")):
                    if key in call["splits"]:
                        assert sum(call["splits"][key]) == rows[arg], where
                    else:
                        assert rows[arg] % call["group_size"] == 0, where
    for per_rank in per_ranks:
        ref.assert_same_scenario(per_rank[i]["result"], sims[i])
