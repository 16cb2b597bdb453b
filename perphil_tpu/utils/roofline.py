"""Roofline characterization of compiled kernels.

Locates a compiled JAX computation on the device roofline: achieved GFLOP/s
and GB/s (from XLA's own cost model via ``compiled.cost_analysis()``)
against the device's peak compute and memory bandwidth. The reference has
no analogue (PETSc logs report MFlops against no roofline).

Peaks are per device and keyed by ``jax.Device.device_kind``. A device that
is not in the table is an error, not a default: a roofline share against
another device's peaks is a wrong number.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
without sparsity, at the full 700 W power limit: 989 TFLOP/s bf16 tensor
core, 67 TFLOP/s FP64 tensor core, 3.35 TB/s HBM3. A card set to a lower
power limit cannot hold these rates; report the limit beside any share.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, NamedTuple, Optional

import jax


class Peaks(NamedTuple):
    bf16_tflops: float
    fp64_tflops: float
    hbm_gbs: float
    label: str


# device_kind -> published peaks (see the module docstring for the source)
PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(989.0, 67.0, 3350.0, "H100 SXM"),
}


def device_peaks(kind: Optional[str] = None) -> Peaks:
    """Published peaks of ``kind`` (default: the first JAX device's kind).

    :raises KeyError: for a device kind that is not in :data:`PEAKS`.
    """
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "perphil_tpu.utils.roofline.PEAKS with its source"
        ) from None


@dataclass
class RooflinePoint:
    """One kernel located on the roofline."""

    name: str
    seconds: float
    flops: float
    bytes: float
    gflops: float  # achieved
    gbs: float  # achieved
    intensity: float  # flops/byte
    fp64_frac: float  # achieved / peak FP64 compute
    hbm_frac: float  # achieved / peak memory bandwidth
    bound: str  # "compute" or "memory" at this intensity (FP64 ridge)
    device: str

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


def cost_of(compiled) -> tuple:
    """(flops, bytes accessed) from XLA's cost analysis of a compiled
    computation (``jax.jit(f).lower(*args).compile()``)."""
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def analyze(
    name: str,
    seconds: float,
    flops: float,
    bytes_accessed: float,
    peaks: Optional[Peaks] = None,
) -> RooflinePoint:
    """Locate a measured kernel execution on the device roofline. The
    solvers compute in float64, so the compute roof is the FP64 peak."""
    pk = peaks or device_peaks()
    gflops = flops / seconds / 1e9
    gbs = bytes_accessed / seconds / 1e9
    intensity = flops / max(bytes_accessed, 1.0)
    ridge = pk.fp64_tflops * 1e3 / pk.hbm_gbs  # flops/byte where roofs meet
    return RooflinePoint(
        name=name,
        seconds=seconds,
        flops=flops,
        bytes=bytes_accessed,
        gflops=gflops,
        gbs=gbs,
        intensity=intensity,
        fp64_frac=gflops / (pk.fp64_tflops * 1e3),
        hbm_frac=gbs / pk.hbm_gbs,
        bound="compute" if intensity >= ridge else "memory",
        device=pk.label,
    )


def analyze_compiled(name: str, fn, args, seconds: float) -> RooflinePoint:
    """Convenience: lower+compile ``fn`` to read XLA's flop/byte counts,
    then locate the measured ``seconds`` on the roofline."""
    compiled = jax.jit(fn).lower(*args).compile()
    flops, nbytes = cost_of(compiled)
    return analyze(name, seconds, flops, nbytes)
