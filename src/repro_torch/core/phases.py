"""Backend registry for the SP-Async round pipeline.

Maps ``(phase, backend_name) -> implementation`` so ``SsspConfig``
validates every backend name eagerly and the round is built by resolution.
The phases and config keys are the reference's (``core/phases.py``), so one
config dict drives both packages:

  ============== ======================= ==================================
  phase          config key              backends
  ============== ======================= ==================================
  round          ``cfg.round``           staged | fused
  local_solver   ``cfg.local_solver``    bellman | delta | pallas
  send           ``cfg.send_backend``    xla | pallas
  exchange       ``cfg.exchange``        bucket | pmin | a2a_dense | async
                                         | async_bucket | async_ppermute
  merge          ``cfg.merge_backend``   xla | pallas
  toka           ``cfg.toka``            toka0 | toka1 | toka2 | toka3
  warm_init      ``cfg.warm_start``      none | landmark
  ============== ======================= ==================================

``pallas`` selects the hand-written CUDA kernel (its plain PyTorch version
on CPU tensors); ``xla`` selects plain PyTorch ops. The ``async*``
exchanges are deferred: a round's sends are delivered one or more rounds
later (``core/sssp.py: ExchangeStage``). Unknown names raise
``ValueError`` listing the valid ones.
"""
from __future__ import annotations

import warnings

_REGISTRY: dict[str, dict[str, object]] = {}

def register(phase: str, name: str):
    """Decorator: register ``obj`` as backend ``name`` of ``phase``."""

    def deco(obj):
        _REGISTRY.setdefault(phase, {})[name] = obj
        return obj

    return deco


def resolve(phase: str, name: str):
    """Look up a backend; an unknown name raises ``ValueError`` listing the
    valid options."""
    impls = _REGISTRY.get(phase, {})
    if name in impls:
        return impls[name]
    raise ValueError(
        f"unknown {phase} backend {name!r}; valid: {sorted(impls)}")


def backends(phase: str) -> tuple[str, ...]:
    """Registered backend names for a phase (stable order)."""
    return tuple(sorted(_REGISTRY.get(phase, ())))


def validate(phase: str, name: str) -> str:
    """``resolve`` for its side effect only; returns ``name`` unchanged."""
    resolve(phase, name)
    return name


_WARNED: set[str] = set()


def warn_once(key: str, message: str) -> None:
    """A ``UserWarning`` once per process and ``key``: a kernel backend
    silently degrading to plain ops would hide a performance cliff."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, UserWarning, stacklevel=3)
