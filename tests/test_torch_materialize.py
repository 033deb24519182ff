"""The port's threefry ``materialize`` against the reference's: the same
``key(seed)`` gives the same weights leaf by leaf, with no
``params_from_numpy`` in between.

``repro_torch.models.params.materialize(defs, prng.key(s))`` is held
against ``repro.models.params.materialize(defs, jax.random.key(s))`` for
one SMOKE config of each family (an LM with MoE, AutoInt, MACE) and a
hand-made tree that mixes normal, zeros, ones and bf16 leaves: float32
leaves within 4 ulp (the normals' ``erf_inv`` is XLA's polynomial, but
its ``log1p`` is not: ``core/prng.py: erf_inv``), bfloat16 leaves within
1 bfloat16 ulp, zeros and ones exact. Swapping two leaves of one shape
must fail the comparison. The port's launcher (``--device cpu --steps
3``) then prints the reference launcher's losses within 1e-5 relative for
an LM and a GNN arch.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.launch import train as jtrain
from repro.models import autoint as jai
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro.models.params import ParamDef as JParamDef
from repro.models.params import materialize as jax_materialize

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import autoint as tai  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import ParamDef, materialize, tree_leaves  # noqa: E402,E501

AX = MeshAxes(data=("data",), data_shards=1)
TAX = TMeshAxes(data=("data",), data_shards=1)
F32_ULPS = 4
BF16_ULPS = 1


def _ordered(bits: np.ndarray) -> np.ndarray:
    """Float bits (as signed ints) -> ints whose differences count ulps."""
    b = bits.astype(np.int64)
    sign = np.int64(1) << (8 * bits.itemsize - 1)
    return np.where(b < 0, -(b & (sign - 1)), b)


def _ulps(got: torch.Tensor, want) -> int:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy()
        w = want.view(np.int16)
    else:
        g = got.numpy().view(np.int32)
        w = want.view(np.int32)
    return int(np.abs(_ordered(g) - _ordered(w)).max(initial=0))


def assert_same_weights(pt, pj, defs_t):
    """Leaf by leaf: shapes and types equal, zeros and ones exact, normal
    leaves within ``F32_ULPS`` (f32) or ``BF16_ULPS`` (bf16)."""
    lt, lj = tree_leaves(pt), jax.tree_util.tree_leaves(pj)
    ld = tree_leaves(defs_t)
    assert len(lt) == len(lj) == len(ld)
    for i, (t, j, d) in enumerate(zip(lt, lj, ld)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, i
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, i
        if d.init in ("zeros", "ones"):
            assert _ulps(t, j) == 0, i
        else:
            limit = BF16_ULPS if t.dtype == torch.bfloat16 else F32_ULPS
            assert _ulps(t, j) <= limit, (i, _ulps(t, j))


def _family_defs(arch):
    """(port defs, reference defs, default dtype) of a SMOKE config."""
    cj = jax_registry._load(arch, smoke=True)[1]
    ct = torch_registry._load(arch, smoke=True)[1]
    if arch == "olmoe-1b-7b":
        return (ttf.param_defs(ct, TAX), jtf.param_defs(cj, AX), ct.dtype,
                cj.dtype)
    if arch == "autoint":
        return (tai.autoint_param_defs(ct, TAX),
                jai.autoint_param_defs(cj, AX),
                "float32", jnp.float32)
    return (tgnn.mace_param_defs(ct, TAX), jgnn.mace_param_defs(cj, AX),
            "float32", jnp.float32)


@pytest.mark.parametrize("arch,seed", [("olmoe-1b-7b", 0), ("autoint", 7),
                                       ("mace", 3)])
def test_materialize_matches_reference(arch, seed):
    defs_t, defs_j, dt_t, dt_j = _family_defs(arch)
    pj = jax_materialize(defs_j, jax.random.key(seed), dt_j)
    pt = materialize(defs_t, prng.key(seed), device="cpu",
                     default_dtype=dt_t)
    assert_same_weights(pt, pj, defs_t)


MIXED = {"w": ((4, 8), "normal", None, None), "b": ((8,), "zeros", None,
                                                     None),
         "g": ((8,), "ones", None, None),
         "emb": ((16, 4), "embed", 0.02, "bfloat16"),
         "v": ((4, 8), "normal", 0.3, None),
         "blocks": [{"a": ((3, 5, 7), "normal", None, "bfloat16")},
                    {"a": ((3, 5, 7), "normal", None, "bfloat16")}]}


def _mixed(make):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return make(*node)
    return walk(MIXED)


def _mixed_pair(seed):
    defs_t = _mixed(lambda s, init, scale, dt: ParamDef(
        s, init=init, scale=scale, dtype=dt and getattr(torch, dt)))
    defs_j = _mixed(lambda s, init, scale, dt: JParamDef(
        s, P(), init=init, scale=scale, dtype=dt and getattr(jnp, dt)))
    return (defs_t, materialize(defs_t, prng.key(seed), device="cpu"),
            jax_materialize(defs_j, jax.random.key(seed)))


@pytest.mark.parametrize("seed", [0, 5])
def test_materialize_mixed_tree_matches_reference(seed):
    """Normal, embed, zeros, ones and bf16 leaves, a list of layers: every
    leaf takes its own key, zeros and ones included, so the order of the
    leaves decides every draw."""
    defs_t, pt, pj = _mixed_pair(seed)
    assert_same_weights(pt, pj, defs_t)


def test_swapped_leaves_fail_the_comparison():
    """The comparison sees a swap of two leaves of one shape and type."""
    defs_t, pt, pj = _mixed_pair(0)
    pt["w"], pt["v"] = pt["v"], pt["w"]
    with pytest.raises(AssertionError):
        assert_same_weights(pt, pj, defs_t)
    _, pt, _ = _mixed_pair(0)
    a, b = pt["blocks"]
    pt["blocks"] = [b, a]
    with pytest.raises(AssertionError):
        assert_same_weights(pt, pj, defs_t)


def test_draw_in_slices_equals_whole_draw(monkeypatch):
    """A leaf drawn in slices of ``DRAW_SLICE`` elements equals the whole
    draw bit for bit."""
    from repro_torch.models import params
    defs = {"x": ParamDef((37, 53)), "y": ParamDef((1000,), scale=0.5)}
    whole = materialize(defs, prng.key(9), device="cpu")
    monkeypatch.setattr(params, "DRAW_SLICE", 100)
    sliced = materialize(defs, prng.key(9), device="cpu")
    for a, b in zip(tree_leaves(whole), tree_leaves(sliced)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gat-cora"])
def test_launcher_losses_match_reference_launcher(arch, capsys):
    """``python -m repro_torch.launch.train --arch <a> --smoke --steps 3
    --device cpu`` against the reference launcher's three losses: the
    weights are both launchers' own ``materialize`` of key 0."""
    args = ["--arch", arch, "--smoke", "--steps", "3", "--log-every", "1"]
    want = jtrain.main(args)
    got = ttrain.main(args + ["--device", "cpu"])
    capsys.readouterr()
    np.testing.assert_allclose(got, want, rtol=1e-5)
