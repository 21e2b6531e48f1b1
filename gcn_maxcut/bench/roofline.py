"""Device peak table and the roofline model for SpMM edges/s.

SpMM over a sparse graph is memory-bound: each directed edge reads an
F-float feature row (gather), an index pair, and a weight, and the output
writes n·F floats.  The speed-of-light edges/s for a device is

    edges/s = HBM_bytes_per_s / bytes_per_edge
    bytes_per_edge ≈ 4·F (gathered row) + 8 (indices) + 4 (weight)
                     + 4·F · (n / E)  (amortized output write)

(reads dominate; a cached row may cost less — this is the pessimistic
no-reuse bound).  The fwd+bwd pair costs ≈ 2× the forward traffic: the
symmetric custom VJP (``ops/segment.py``) makes the backward the SAME
gather over dL/dy with Aᵀ = A structure — one more pass, no scatter.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_gbps: float           # device memory bandwidth, GB/s
    bf16_tflops: float        # dense tensor-core peak
    tf32_tflops: float
    f32_tflops: float         # outside the tensor cores


# Keyed by ``jax.devices()[0].device_kind``.  NVIDIA H100 SXM data sheet,
# dense rates without sparsity, at the card's full 700 W power limit.
_DEVICES = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "NVIDIA H100 SXM", 3350.0, 989.0, 495.0, 67.0
    ),
}


def device_specs(device_kind: str) -> DeviceSpec:
    """Peaks of ``device_kind``; a device missing from the table is an
    error, never a default."""
    try:
        return _DEVICES[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak table entry for device kind {device_kind!r} "
            f"(known: {sorted(_DEVICES)})"
        ) from None


@dataclasses.dataclass
class RooflineModel:
    device: DeviceSpec
    feature_dim: int
    n_nodes: int
    n_edges: int              # directed

    @property
    def bytes_per_edge_fwd(self) -> float:
        gather = 4.0 * self.feature_dim
        idx = 8.0 + 4.0
        out = 4.0 * self.feature_dim * (self.n_nodes / max(1, self.n_edges))
        return gather + idx + out

    #: fwd+bwd traffic multiple for the symmetric-VJP gathers (backward =
    #: one more forward-shaped gather pass; see module docstring)
    FWD_BWD_FACTOR = 2.0

    def edges_per_s(self, fwd_bwd: bool = True) -> float:
        factor = self.FWD_BWD_FACTOR if fwd_bwd else 1.0
        return self.device.hbm_gbps * 1e9 / (self.bytes_per_edge_fwd * factor)

    def fraction_of_roofline(self, measured_edges_per_s: float, fwd_bwd: bool = True) -> float:
        return measured_edges_per_s / self.edges_per_s(fwd_bwd)
