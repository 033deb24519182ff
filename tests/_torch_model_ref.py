"""The JAX package's one AdamW step for the model tests
(tests/test_torch_gnn.py, tests/test_torch_autoint.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw


def reference_step(pj, gj):
    """The reference's one AdamW step from a fresh state: (parameters
    after it, as a list of leaves, gradient norm). ``adamw_update`` runs
    on the tree's leaves laid end to end as one leaf: its update is
    elementwise but for the global norm, so this equals the update leaf by
    leaf, and jit compiles one leaf instead of the tree's dozens."""
    leaves = jax.tree_util.tree_leaves(pj)

    def flat(t):
        return {"x": jnp.concatenate([jnp.ravel(a) for a in
                                      jax.tree_util.tree_leaves(t)])}

    p2, _, gnorm = jax.jit(lambda p, g: jadamw.adamw_update(
        p, g, jadamw.adamw_init(p), JAdamWConfig()))(flat(pj), flat(gj))
    bounds = np.cumsum([0] + [a.size for a in leaves])
    x = np.asarray(p2["x"])
    return [x[lo:hi].reshape(a.shape) for lo, hi, a in
            zip(bounds[:-1], bounds[1:], leaves)], float(gnorm)
