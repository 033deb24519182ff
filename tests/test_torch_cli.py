"""The port's runner (``python -m repro_torch.launch.sssp_run``) against the
reference's (``repro.launch.sssp_run``): every case of tests/test_cli.py
runs both in-process on the same argv (the port's with ``--device cpu``),
and their printed lines, with the timings masked, their exit codes, their
last error line and the errors they raise must be equal. Then what only
the port has: ``--backend shmap``'s checks of its flags, and with no
``--device`` the runner asks for the card.
"""
import re
import sys

import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import sssp_run as jrun  # noqa: E402
from repro_torch.launch import sssp_run as trun  # noqa: E402

TINY = ("--graph", "random", "--scale", "7", "--edge-factor", "4",
        "--parts", "4", "--no-prune")
# tests/test_cli.py's argvs, case by case
CASES = {
    "bad-graph": ["--graph", "mystery"],
    "bad-exchange": ["--exchange", "carrier-pigeon"],
    "bad-solver": ["--solver", "dijkstra"],
    "bad-warm-start": ["--warm-start", "oracle"],
    "bad-backend": ["--backend", "mpi"],
    "warm-start-needs-landmarks": [*TINY, "--warm-start", "landmark"],
    "source-out-of-range": [*TINY, "--sources", "999999"],
    "single-source": [*TINY, "--source", "3", "--validate"],
    "explicit-batch": [*TINY, "--sources", "0,5,9", "--exchange", "pmin",
                       "--toka", "toka1", "--solver", "delta", "--validate"],
    "sampled-batch": [*TINY, "--num-sources", "4", "--batch"],
    "warm-start-and-cache": [*TINY, "--sources", "0,5", "--warm-start",
                             "landmark", "--landmarks", "3",
                             "--result-cache", "8", "--validate"],
    "result-cache": [*TINY, "--sources", "1,8", "--result-cache", "4"],
    "lag-zero": [*TINY, "--async-lag", "0", "--exchange", "async"],
    "lag-on-sync": [*TINY, "--async-lag", "2"],
    "lag-on-ppermute": [*TINY, "--async-lag", "2", "--exchange",
                        "async_ppermute"],
    "async": [*TINY, "--sources", "0,5,9", "--exchange", "async",
              "--validate"],
    "async-ppermute-fused": [*TINY, "--source", "3", "--exchange",
                             "async_ppermute", "--round", "fused",
                             "--validate"],
    "faults-heal": [*TINY, "--sources", "0,5", "--fault-drop", "0.2",
                    "--resend-period", "4", "--toka", "toka3", "--validate"],
    "faults-degraded": [*TINY, "--sources", "0,5", "--fault-drop", "0.6",
                        "--fault-seed", "2", "--validate"],
}
# what tests/test_cli.py asserts of each run's output, beside equality
EXPECT = {
    "single-source": ["validation vs Dijkstra (1 query): OK", "reachable:"],
    "explicit-batch": ["sources=[0, 5, 9]", "query[2] source=9:",
                       "validation vs Dijkstra (3 queries): OK"],
    "sampled-batch": ["bucket K=4", "query[3]"],
    "warm-start-and-cache": ["landmarks: 3 pivots solved",
                             "warm_start=landmark", "[warm-started]",
                             "cache_hits=2/2", "rounds=0",
                             "validation vs Dijkstra (2 queries): OK"],
    "result-cache": ["cache_hits=2/2"],
    "async": ["async: overlap=", "stale_merges=", "bytes_moved=",
              "validation vs Dijkstra (3 queries): OK"],
    "async-ppermute-fused": ["async: overlap=",
                             "validation vs Dijkstra (1 query): OK"],
    "faults-heal": ["status: converged (converged 2/2 queries)", "resends=",
                    "validation vs Dijkstra (2 queries): OK"],
    "faults-degraded": ["validation FAILED: status=degraded"],
}
# a time in seconds or milliseconds, and the rates made from the solve time
_TIMES = re.compile(r"\d+\.\d+m?s\b|(MTEPS|queries/s)=\S+")


def _run(module, argv, monkeypatch, capsys):
    """(exit code, error raised, output lines with the times masked, last
    line of standard error) of one in-process run."""
    monkeypatch.setattr(sys, "argv", ["sssp_run", *argv])
    code, error = 0, None
    try:
        module.main()
    except SystemExit as e:
        code = e.code
    except ValueError as e:
        error = ("ValueError", str(e))
    out, err = capsys.readouterr()
    lines = [_TIMES.sub("T", line) for line in out.splitlines()]
    return code, error, lines, (err.strip().splitlines() or [""])[-1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_matches_reference(case, monkeypatch, capsys):
    argv = CASES[case]
    want = _run(jrun, argv, monkeypatch, capsys)
    got = _run(trun, [*argv, "--device", "cpu"], monkeypatch, capsys)
    assert got == want
    code, error, lines, err = got
    out = "\n".join(lines)
    for text in EXPECT.get(case, ()):
        assert text in out, text
    if case.startswith(("bad-", "lag-", "warm-start-needs")):
        assert code == 2 and "error" in err
    if case.startswith("lag-"):
        assert "--async-lag" in err
    if case == "warm-start-needs-landmarks":
        assert "--landmarks" in err
    if case == "source-out-of-range":
        assert error is not None and "out of range" in error[1]
    if case == "faults-degraded":
        assert code == 1
    if case in EXPECT and case != "faults-degraded":
        assert code == 0 and error is None


def test_shmap_backend_names_its_roadmap_item(monkeypatch, capsys):
    """``--backend shmap`` is ported (one process a part, under torchrun;
    tests/test_torch_dist_comm.py runs it): without its communication
    backend it exits naming the flag, and outside torchrun (world size 1)
    ``--parts 4`` exits naming the world size."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    code, _, lines, err = _run(trun, [*TINY, "--backend", "shmap",
                                      "--device", "cpu"],
                               monkeypatch, capsys)
    assert code == 2 and "requires --dist-backend" in err and not lines
    code, _, lines, err = _run(trun, [*TINY, "--backend", "shmap",
                                      "--dist-backend", "gloo", "--device",
                                      "cpu"], monkeypatch, capsys)
    assert code == 2 and "must equal the world size 1" in err and not lines


def test_runner_defaults_to_the_card(monkeypatch, capsys):
    """With no ``--device`` the solve runs on ``cuda``; without a card it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", ["sssp_run", *TINY, "--source", "3"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main()
