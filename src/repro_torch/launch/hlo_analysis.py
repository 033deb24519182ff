"""Collective traffic and roofline terms of a step on H100s (the
reference's ``launch/hlo_analysis.py``, with the cards' constants in
place of the TPU v5e's).

The reference parses the collectives of a compiled, partitioned XLA
program out of its HLO text. A PyTorch step has no HLO; the port records
the collectives its steps issue instead (``distributed/collectives.py:
recording``), and ``collective_bytes`` sums that record into per-device
wire bytes with the reference's algorithm models:

  all-reduce         2 * bytes * (P-1)/P      (ring RS + AG)
  all-gather         bytes * (P-1)/P          (result bytes include the P x)
  reduce-scatter     bytes * (P-1)/P          (input bytes)
  all-to-all         bytes * (P-1)/P
  collective-permute bytes                    (one hop)

where the reference takes P as the whole mesh's size, the port takes each
collective's own group (16 ranks for an axis of the production mesh, 256
or 512 for the whole): a collective over one axis moves its bytes among
that axis's ranks only. A reduce-scatter's bytes are its input's, as the
formula says (the reference's parser reads the HLO result's shape, 1/P
of them).

Hardware model: the NVIDIA H100 SXM5 80GB at its 700 W power limit, the
dense (no sparsity) rates of NVIDIA's H100 data sheet; a card set below
700 W runs slower under load. The collective bytes are divided by one
card's link rate: NVLink 4 (450 GB/s a direction) for a mesh of up to 8
cards, which fits one DGX H100 node; for a larger mesh, whose groups span
nodes (both axes of the production meshes hold 16 ranks), the node's one
400 Gb/s NIC a card (50 GB/s).
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12       # bf16 dense tensor-core FLOP/s (H100 SXM5)
HBM_BW = 3.35e12            # bytes/s of HBM3 (H100 SXM5)
NVLINK_BW = 450e9           # bytes/s per direction of NVLink 4 (H100 SXM5)
NIC_BW = 50e9               # bytes/s of a card's 400 Gb/s NIC (DGX H100)
NODE_CARDS = 8              # cards a DGX H100 node joins by NVLink
# bytes of device memory of an H100 80GB HBM3, as torch.cuda reports them
HBM_BYTES = 85_017_493_504

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(trace, n_devices: int, loop_scale: int = 1) -> dict:
    """Sum per-collective wire bytes (per device) of ``trace``, a record
    of ``Collective`` (kind, bytes, group size) from
    ``collectives.recording``; the reference's keys. Each collective's
    ``(P-1)/P`` takes its own group's size (``n_devices`` where a record
    has none). The record holds every call a Python loop made, so a
    step's record takes ``loop_scale`` 1; a record of one trip of a loop
    (one SSSP round) takes the trip count to total the loop. A ``str``
    (the reference's HLO text) raises: a PyTorch step has no HLO."""
    if isinstance(trace, str):
        raise NotImplementedError(
            "hlo_analysis.collective_bytes takes the record of the "
            "collectives a step issued (collectives.recording); the port "
            "runs PyTorch steps and has no HLO to parse")
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for c in trace:
        P = c.group_size or n_devices
        frac = (P - 1) / max(P, 1)
        if c.kind == "all-reduce":
            wire = 2 * c.nbytes * frac
        elif c.kind == "collective-permute":
            wire = c.nbytes
        else:
            wire = c.nbytes * frac
        out[c.kind] += int(wire * loop_scale)
        counts[c.kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_devices: int, model_flops: float = 0.0) -> dict:
    """The reference's terms on the cards' constants: ``flops`` and
    ``hbm_bytes`` per device, ``coll_bytes`` per-device wire bytes (0 on
    one card) over the link rate of a mesh of ``n_devices`` (the module
    docstring), ``model_flops`` the global useful work."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    coll_s = coll_bytes / (NVLINK_BW if n_devices <= NODE_CARDS else NIC_BW)
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
