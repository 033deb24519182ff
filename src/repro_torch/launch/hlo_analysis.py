"""Roofline terms of a step on one H100 (the reference's
``launch/hlo_analysis.py``, with the card's constants in place of the TPU
v5e's).

The reference parses the collective traffic of a compiled, partitioned
XLA program out of its HLO text (``collective_bytes``). The port runs
PyTorch on one card and has no HLO and no partitioner, so that parser is
an explicit omission and raises; a one-card step moves no collective
bytes.

Hardware model: one NVIDIA H100 SXM5 80GB at its 700 W power limit, the
dense (no sparsity) rates of NVIDIA's H100 data sheet. A card set below
700 W runs slower under load.
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12       # bf16 dense tensor-core FLOP/s (H100 SXM5)
HBM_BW = 3.35e12            # bytes/s of HBM3 (H100 SXM5)
NVLINK_BW = 450e9           # bytes/s per direction of NVLink 4 (H100 SXM5)
# bytes of device memory of an H100 80GB HBM3, as torch.cuda reports them
HBM_BYTES = 85_017_493_504


def collective_bytes(hlo_text: str, n_devices: int,
                     loop_scale: int = 1) -> dict:
    """Not ported: the reference sums the wire bytes of the collectives in
    a partitioned XLA program's HLO text, which a PyTorch step does not
    have."""
    raise NotImplementedError(
        "hlo_analysis.collective_bytes parses XLA HLO text; the port runs "
        "PyTorch steps on one card and has no HLO to parse (an explicit "
        "omission, ROADMAP Queue 1)")


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_devices: int, model_flops: float = 0.0) -> dict:
    """The reference's terms on the card's constants: ``flops`` and
    ``hbm_bytes`` per device, ``coll_bytes`` per-device wire bytes (0 on
    one card), ``model_flops`` the global useful work."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    coll_s = coll_bytes / NVLINK_BW
    bound_s = max(compute_s, memory_s, coll_s)
    dominant = max((compute_s, "compute"), (memory_s, "memory"),
                   (coll_s, "collective"))[1]
    counted = flops * n_devices
    return dict(
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / counted) if counted else 0.0,
        bound_s=bound_s,
        roofline_fraction=compute_s / bound_s if bound_s > 0 else 0.0)
