"""The port's quickstart (``repro_torch.examples.quickstart``) on the CPU,
at the reference example's own size (R-MAT scale 10, P = 8): every one of
its eight steps completes (each asserts its own claim: Dijkstra
agreement, bit-identity across backends, fused, warm, cached, faulted,
async and ragged solves), and the distances it reports equal the JAX
package's Dijkstra at the example's tolerance."""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.graph as jg  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402


def test_quickstart_runs_every_step_on_cpu(capsys):
    out = quickstart.main(device="cpu")
    text = capsys.readouterr().out
    for line in ("graph: 1024 vertices",
                 "single-source distances match Dijkstra: True",
                 "batched distances match Dijkstra (6 queries, bucket K=8): "
                 "True",
                 "second solve, same bucket: compiled=False",
                 "streamed queries: True",
                 "kernel send/merge bit-identical to the plain backends: True",
                 "fused round bit-identical",
                 "landmark-seeded", "exact repeat from the result cache",
                 "20% message drop, healed: status=converged",
                 "async exchange at P=8", "ragged stream-built shards"):
        assert line in text, line
    g = jg.rmat_graph(scale=10, edge_factor=8, seed=0)
    for src, row in ([(out["source"], out["single"].dist[0])]
                     + list(zip(out["sources"], out["batch"].dist))):
        np.testing.assert_allclose(row, jg.dijkstra_reference(g, src),
                                   rtol=1e-5, atol=1e-4)
