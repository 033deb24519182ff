"""The port's multi-process backend against the reference's own
``shmap`` backend: the reference's ``solve_shmap_batch`` on four spoofed
host devices (a subprocess, since the device count is fixed when JAX
starts) and the port's ``solve_shmap_batch`` on 4 gloo ranks solve the
reference's fixture graph under four configurations: the default
``bucket``; ``async_ppermute`` with toka2; the fused round under ``pmin``;
``bucket`` under drop with anti-entropy resend and toka3. Distances and
every counter must be equal, tolerance zero.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "bucket": dict(),
    "async_ppermute-toka2": dict(exchange="async_ppermute", toka="toka2"),
    "fused-pmin": dict(round="fused", exchange="pmin"),
    "bucket-drop-resend-toka3": dict(
        toka="toka3", faults=dict(drop=0.2, seed=0, resend_period=4)),
}

_JAX_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    from repro import compat
    from repro.core import (FaultPlan, SsspConfig, build_shards,
                            solve_shmap_batch)
    from repro.graph import random_graph

    out, configs = sys.argv[1], eval(sys.argv[2])
    sh = build_shards(random_graph(n=180, m=720, seed=3), 4)
    mesh = compat.make_mesh((4,), ("d",))
    arrays = {}
    for name, cfg in configs.items():
        cfg = dict(cfg)
        if "faults" in cfg:
            cfg["faults"] = FaultPlan(**cfg["faults"])
        dist, stats = solve_shmap_batch(sh, [0, 7, 11], SsspConfig(**cfg),
                                        mesh, ("d",))
        arrays[f"{name}/dist"] = np.asarray(dist)
        for f in stats._fields:
            arrays[f"{name}/{f}"] = np.asarray(getattr(stats, f))
    np.savez(out, **arrays)
    print("JAX SHMAP OK")
""")


def rank_solves(mesh, device, configs):
    """A rank's side: the port's ``solve_shmap_batch`` of each config."""
    import repro_torch.core as tc
    sh = ref.shards("fixture")
    return [tc.solve_shmap_batch(sh, ref.SOURCES, ref.make_config(cfg), mesh,
                                 mesh.axis_names, device=device)
            for cfg in configs]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's arrays, each rank's results); the reference's
    subprocess runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("dist_jax")
    out = os.path.join(str(tmp), "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_PROG, out, repr(CONFIGS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        per_rank = ref.run_ranks(rank_solves, tmp, list(CONFIGS.values()),
                                 world=4)
    finally:
        stdout, stderr = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, stdout + stderr[-3000:]
    assert "JAX SHMAP OK" in stdout
    return dict(np.load(out)), per_rank


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shmap_matches_reference_shmap(both, name):
    jax_arrays, per_rank = both
    i = list(CONFIGS).index(name)
    for res in per_rank:
        dist, stats = res[i]
        np.testing.assert_array_equal(dist, jax_arrays[f"{name}/dist"])
        for f in ref.COUNTERS:
            np.testing.assert_array_equal(
                np.asarray(getattr(stats, f)), jax_arrays[f"{name}/{f}"],
                err_msg=f)
    if name.startswith("bucket-drop"):
        assert int(per_rank[0][i][1].resends) > 0
