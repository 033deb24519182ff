"""The JAX side of the port's tests: one persistent compilation cache that
the workers of a test run share.

Most of a port test's time on the CPU is JAX compiling the reference it is
held against, and many tests compile the same programs: the same engine
configs on the same fixture graphs, in the port's files and in the
reference's own. ``shared_jax_cache`` turns on JAX's persistent
compilation cache in the run's temporary directory (pytest's basetemp;
under pytest-xdist the parent of the workers' basetemps, which they
share), so a program compiled once in a run loads from the cache in every
later test and worker. A loaded program is the executable XLA built for
that program, so no result changes. The directory lives and goes with
pytest's temporary directories, never in the repository.

A test module that runs JAX imports the fixture (``from _torch_jax_ref
import shared_jax_cache``); it is autouse and session-scoped, so a worker
turns the cache on before its first such test and keeps it for the rest of
the run, the reference's tests included. The same settings go into the
worker's environment, where the JAX processes that tests start (the
reference's multi-device programs) read them. A cache directory set by
the caller (``JAX_COMPILATION_CACHE_DIR``) is left as it is.
"""
import os

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache


@pytest.fixture(scope="session", autouse=True)
def shared_jax_cache(tmp_path_factory):
    if jax.config.jax_compilation_cache_dir:
        yield
        return
    base = tmp_path_factory.getbasetemp()
    run = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    # every program, however quick its compile: the CPU's compiles are
    # short one by one and many in all
    settings = {"jax_compilation_cache_dir": str(run / "jax-cache"),
                "jax_persistent_cache_min_compile_time_secs": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in settings.items():
            jax.config.update(name, value)
            mp.setenv(name.upper(), str(value))
        # the cache is checked once a process: look again now that it is set
        compilation_cache.reset_cache()
        yield
