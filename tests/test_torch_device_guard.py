"""Every hand kernel launches on the card that holds its operands.

The port's kernel wrappers call their CUDA libraries through one helper,
``repro_torch.kernels.build.call``, which sets the operands' card for the
length of the call with PyTorch's device guard and takes that card's
current stream; operands on two cards raise ``ValueError`` before any
launch (``kernels.common.same_card``). These tests hold that on the CPU,
where no card exists: an AST walk finds any call into a loaded library
that does not go through the helper; the helper runs against a stand-in
library with the guard and the stream recorded; the wrappers meet
stand-in operands on two cards. The card itself is held in
``tests/test_torch_gpu.py`` (two cards or more) and ``chip_smoke.py
cards``.
"""
import ast
import threading
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build
from repro_torch.kernels.common import same_card
from repro_torch.kernels.embedding_bag import embedding_bag_p
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_p)
from repro_torch.kernels.merge import (merge_scatter_ragged,
                                       merge_scatter_tiled)
from repro_torch.kernels.relax import (relax_dst_ragged_fixpoint_batch,
                                       relax_dst_tiled,
                                       relax_dst_tiled_fixpoint,
                                       relax_dst_tiled_fixpoint_batch,
                                       relax_dst_tiled_masked)
from repro_torch.kernels.round import fused_round_ragged, fused_round_tiled
from repro_torch.kernels.send import send_pack_ragged, send_pack_tiled

KERNELS = Path(build.__file__).parent
# the loader (it sets each entry point's signature and calls none), the
# helper, and the error text the helper reads after a failed launch
ALLOWED = {("build.py", "load"), ("build.py", "call"), ("build.py", "check")}


def raw_library_calls(source: str, filename: str) -> list[str]:
    """``file:line`` of every use of a loaded kernel library outside the
    guarded helper: an attribute of, or ``getattr`` on, a name bound to
    ``build.load(...)`` / ``load(...)`` or a parameter named ``lib``, and
    any ``ctypes.CDLL`` outside ``build.py``."""
    tree = ast.parse(source)
    libs = {"lib"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and _name_of(node.value.func) in ("build.load", "load")):
            libs.update(t.id for t in node.targets
                        if isinstance(t, ast.Name))
    found = []

    def visit(node, func):
        if isinstance(node, ast.FunctionDef):
            func = node.name
        if (filename, func) not in ALLOWED:
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in libs):
                found.append(f"{filename}:{node.lineno} {node.value.id}."
                             f"{node.attr}")
            if (isinstance(node, ast.Call) and _name_of(node.func) == "getattr"
                    and node.args and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in libs):
                found.append(f"{filename}:{node.lineno} getattr("
                             f"{node.args[0].id}, ...)")
            if (isinstance(node, ast.Attribute) and node.attr == "CDLL"
                    and filename != "build.py"):
                found.append(f"{filename}:{node.lineno} ctypes.CDLL")
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return found


def _name_of(func) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return f"{func.value.id}.{func.attr}"
    return ""


def test_every_library_call_goes_through_the_guarded_helper():
    files = sorted(KERNELS.rglob("*.py"))
    assert len(files) >= 20
    found = []
    for f in files:
        found += raw_library_calls(f.read_text(),
                                   str(f.relative_to(KERNELS)))
    assert not found, ("calls into a kernel library that bypass "
                       "build.call:\n" + "\n".join(found))


@pytest.mark.parametrize("snippet,what", [
    ("lib = build.load('relax', S)\ncode = lib.relax_sweep(1, 2)\n",
     "lib.relax_sweep"),
    ("def f(lib, name):\n    return getattr(lib, name)(0)\n",
     "getattr(lib, ...)"),
    ("mylib = load('send', S)\nfn = mylib.send_smem_bytes\n",
     "mylib.send_smem_bytes"),
    ("import ctypes\nx = ctypes.CDLL('libx.so')\n", "ctypes.CDLL"),
])
def test_the_walk_finds_a_planted_raw_call(snippet, what):
    found = raw_library_calls(snippet, "planted.py")
    assert found and what in found[0] and found[0].startswith("planted.py:")


class _Guard:
    """Stand-in for the card state that torch.cuda keeps: the current card,
    the cards the guard entered, and a recording ``torch.cuda.device``."""

    def __init__(self, current):
        self.current = current
        self.entered = []
        guard = self

        class device:
            def __init__(self, idx):
                self.idx = idx

            def __enter__(self):
                guard.entered.append(self.idx)
                self.prev, guard.current = guard.current, self.idx

            def __exit__(self, *exc):
                guard.current = self.prev
                return False

        self.device = device


class _Lib:
    """Stand-in kernel library: records each call's arguments and the card
    current during it, and returns ``code``."""

    def __init__(self, guard, code=0):
        self.guard, self.code, self.calls = guard, code, []

    def launch_it(self, *args):
        self.calls.append((args, self.guard.current))
        return self.code

    def repro_error_string(self, code):
        return b"invalid resource handle"


@pytest.fixture
def guard(monkeypatch):
    g = _Guard(current=0)
    monkeypatch.setattr(build, "_current_card", lambda: g.current)
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(build, "current_stream",
                        lambda dev: 1000 + dev.index)
    return g


def test_call_launches_on_the_operands_card_and_restores_the_callers(guard):
    lib = _Lib(guard)
    build.call(lib, "launch_it", torch.device("cuda", 2), 7, 8,
               launch="relax")
    assert lib.calls == [((7, 8, 1002), 2)]     # card 2's stream, on card 2
    assert guard.entered == [2] and guard.current == 0


def test_call_restores_the_callers_card_when_the_launch_fails(guard):
    lib = _Lib(guard, code=400)
    with pytest.raises(RuntimeError, match="relax failed to launch: invalid "
                       "resource handle"):
        build.call(lib, "launch_it", torch.device("cuda", 3), launch="relax")
    assert lib.calls == [((1003,), 3)]
    assert guard.entered == [3] and guard.current == 0


def test_call_on_the_current_card_enters_no_guard(guard):
    guard.current = 1
    lib = _Lib(guard)
    build.call(lib, "launch_it", torch.device("cuda", 1), 5, launch="send")
    assert lib.calls == [((5, 1001), 1)] and guard.entered == []


def test_a_query_runs_on_the_card_and_returns_its_value(guard):
    lib = _Lib(guard, code=4096)
    assert build.call(lib, "launch_it", torch.device("cuda", 1), 3, 4) == 4096
    assert lib.calls == [((3, 4), 1)]           # no stream, no check
    assert guard.entered == [1] and guard.current == 0


def test_a_query_is_kept_per_card_and_arguments(guard):
    lib = _Lib(guard, code=512)
    one, two = torch.device("cuda", 0), torch.device("cuda", 2)
    values = [build.call(lib, "launch_it", d, *a)
              for d, a in ((one, (8, 3)), (one, (8, 3)), (one, (9, 3)),
                           (two, (8, 3)), (two, (8, 3)))]
    assert values == [512] * 5
    assert lib.calls == [((8, 3), 0), ((9, 3), 0), ((8, 3), 2)]
    assert guard.entered == [2] and guard.current == 0


class _OnCard:
    """Stand-in for a CUDA tensor: a wrapper reads ``is_cuda`` and the
    card of every operand before anything else."""
    is_cuda = True

    def __init__(self, index):
        self.device = torch.device("cuda", index)

    def get_device(self):
        return self.device.index


def _cards(n, last=1):
    """n operands on card 0, the last on card ``last``."""
    return [_OnCard(0) for _ in range(n - 1)] + [_OnCard(last)]


def _round_args(card_of_last):
    lay = tuple(_OnCard(0) for _ in range(4))
    return [_OnCard(0) for _ in range(6)] + [
        (*lay[:3],), lay, (*lay[:3], _OnCard(card_of_last))]


WRAPPERS = {
    "relax (kernel 1)": lambda: relax_dst_tiled_fixpoint_batch(
        *_cards(6), vb=32, n_sweeps=2),
    "relax (kernel 1, live chunks)": lambda: relax_dst_tiled_fixpoint_batch(
        *_cards(6, 0), vb=32, n_sweeps=2, chunks=(_OnCard(0), _OnCard(1))),
    "relax_ragged (kernel 2)": lambda: relax_dst_ragged_fixpoint_batch(
        *_cards(7), vb=32, n_sweeps=2),
    "relax_single (kernel 9)": lambda: relax_dst_tiled_fixpoint(
        *_cards(6), vb=32, n_sweeps=2),
    "relax_masked (kernel 10)": lambda: relax_dst_tiled_masked(
        *_cards(6), vb=32),
    "relax_masked (kernel 10, live chunks)": lambda: relax_dst_tiled_masked(
        *_cards(6, 0), vb=32, chunks=(_OnCard(0), _OnCard(1))),
    "relax_sweep (kernel 11)": lambda: relax_dst_tiled(*_cards(4), vb=32),
    "send (kernel 3)": lambda: send_pack_tiled(*_cards(7), sb=32),
    "send_ragged (kernel 4)": lambda: send_pack_ragged(*_cards(8), sb=32),
    "send_ragged (kernel 4, tile bounds)": lambda: send_pack_ragged(
        *_cards(8, 0), sb=32, bounds=_OnCard(1)),
    "merge (kernel 5)": lambda: merge_scatter_tiled(*_cards(5), vb=32),
    "merge_ragged (kernel 6)": lambda: merge_scatter_ragged(*_cards(6),
                                                            vb=32),
    "round (kernel 7)": lambda: fused_round_tiled(
        *_round_args(1), vb=32, sb=32, n_sweeps=2, dense=False,
        chunks=((_OnCard(0),) * 2,) * 3),
    "round (kernel 7, live chunks)": lambda: fused_round_tiled(
        *_round_args(0), vb=32, sb=32, n_sweeps=2, dense=False,
        chunks=((_OnCard(0),) * 2, (_OnCard(0), _OnCard(1)),
                (_OnCard(0),) * 2)),
    "round_ragged (kernel 8)": lambda: fused_round_ragged(
        *_round_args(1), vb=32, sb=32, n_sweeps=2, dense=False),
    "flash_attention (kernel 12)": lambda: flash_attention_p(
        *_cards(3), scale=0.1, causal=True, q_offset=0, kv_len=64,
        block_q=64, block_k=64),
    "embedding_bag (kernel 13)": lambda: embedding_bag_p(*_cards(2)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_operands_on_two_cards_raise_before_any_launch(name, monkeypatch):
    def no_load(*a, **k):
        raise AssertionError("a library was loaded for a launch")

    monkeypatch.setattr(build, "load", no_load)
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match=r"two cards, cuda:0 and cuda:1"):
        WRAPPERS[name]()
    assert build.LAUNCHES == n0


def test_same_card_returns_the_card_and_skips_none():
    ops = (_OnCard(2), None, (_OnCard(2), (None, _OnCard(2))))
    assert same_card("k", *ops) == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="k: operands on two cards, cuda:2 "
                       "and cuda:0"):
        same_card("k", *ops, [_OnCard(0)])


def test_a_cpu_tensor_beside_a_card_tensor_raises():
    with pytest.raises(ValueError, match="cuda:0 and cpu"):
        same_card("merge", _OnCard(0), torch.zeros(2))


def test_resolve_device_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device_mod.resolve_device(None) == torch.device("cuda", 3)
    assert device_mod.resolve_device("cuda") == torch.device("cuda", 3)
    assert device_mod.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    assert str(device_mod.resolve_device(torch.device("cuda", 2))) == "cuda:2"


def test_launch_counts_add_up_across_threads():
    build.reset_launches()
    threads = [threading.Thread(target=lambda: [
        build.count_launch("relax") for _ in range(20_000)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert build.LAUNCHES["relax"] == 80_000
    build.reset_launches()
