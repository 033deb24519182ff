"""The PyTorch port's data pipelines against the JAX package's: the same
seed gives the same tokens, labels and sparse indices element for element
(int32 tensors on the device asked for), batch after batch."""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

from repro.data import pipelines as jpipe

torch = pytest.importorskip("torch")

from repro_torch.data import pipelines as tpipe  # noqa: E402


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.dtype == torch.int32 and t.device.type == "cpu", key
        assert np.array_equal(t.numpy(), np.asarray(want[key])), key


@pytest.mark.parametrize("batch,seq,vocab", [(4, 32, 100), (2, 7, 50304)])
def test_lm_batches_match_reference(batch, seq, vocab):
    _same(tpipe.synthetic_lm_batch(np.random.default_rng(3), batch, seq,
                                   vocab, device="cpu"),
          jpipe.synthetic_lm_batch(np.random.default_rng(3), batch, seq,
                                   vocab))
    jt = jpipe.TokenStream(batch, seq, vocab, seed=5)
    tt = tpipe.TokenStream(batch, seq, vocab, seed=5, device="cpu")
    assert iter(tt) is tt
    for _ in range(3):
        _same(next(tt), next(jt))
    b = next(tpipe.TokenStream(4, 32, 100, device="cpu"))
    # the copy structure the loss can learn (tests/test_optim_data.py)
    assert float((b["tokens"] == b["labels"]).float().mean()) > 0.2


@pytest.mark.parametrize("batch,fields,vocab,hot", [(16, 5, 100, 2),
                                                    (64, 39, 1000, 1)])
def test_recsys_batches_match_reference(batch, fields, vocab, hot):
    jt = jpipe.RecsysBatcher(batch, fields, vocab, hot, seed=7)
    tt = tpipe.RecsysBatcher(batch, fields, vocab, hot, seed=7, device="cpu")
    for _ in range(3):
        got = next(tt)
        _same(got, next(jt))
    assert tuple(got["sparse_idx"].shape) == (batch, fields, hot)
    assert int(got["sparse_idx"].max()) < fields * vocab


def test_graph_batcher_matches_reference():
    def builder(i):
        return {"i": np.int32(i)}
    for steps in (None, 3):
        jt, tt = jpipe.GraphBatcher(builder, steps), tpipe.GraphBatcher(
            builder, steps)
        got = [b["i"] for _, b in zip(range(5), tt)]
        assert got == [b["i"] for _, b in zip(range(5), jt)]
        assert got == ([1, 2, 3, 4, 5] if steps is None else [1, 2, 3])


def test_pipelines_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tpipe.TokenStream(2, 4, 10),
                 lambda: tpipe.RecsysBatcher(2, 3, 10),
                 lambda: tpipe.synthetic_lm_batch(np.random.default_rng(0),
                                                  2, 4, 10)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
