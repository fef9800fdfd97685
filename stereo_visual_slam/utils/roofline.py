"""Roofline / MFU accounting for the production programs.

FLOP and device-memory byte counts come from XLA's own post-optimization
cost model (`compiled.cost_analysis()`), so they track the program actually
executed — fusion, rematerialization and layout padding included — rather
than a hand-derived estimate. MFU is reported against the bf16 tensor-core
peak (the conservative convention: the pipeline's matmuls are bf16 or f32,
and most of its work is elementwise).

Peaks are keyed by `jax.Device.device_kind`; a device that is not in the
table is an error. Times passed in must be measured on that device. The
published rates hold only at the power limit they were stated for (700 W
for the H100 SXM); a card set lower runs slower under load, so shares are
given only when the card's limit (`power_limit_w`) equals the table's.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple


class DevicePeaks(NamedTuple):
    name: str
    bf16_flops: float     # FLOP/s, dense tensor core
    tf32_flops: float     # FLOP/s, dense tensor core
    fp32_flops: float     # FLOP/s, outside the tensor cores
    hbm_bytes: float      # B/s
    power_w: float        # the power limit the rates assume


# NVIDIA H100 data sheet, SXM part, dense rates without sparsity.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "NVIDIA H100 SXM", 989e12, 495e12, 67e12, 3.35e12, 700.0
    ),
}


def device_peaks(kind: str | None = None) -> DevicePeaks:
    """Published peaks of `kind` (default: the first JAX device's kind)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add them to "
            "utils/roofline.PEAKS with their source"
        ) from None


def power_limit_w() -> float:
    """The first GPU's power limit in watts, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.splitlines()[0])


class ProgramCost(NamedTuple):
    flops: float
    bytes_accessed: float

    def mfu(self, seconds: float, peaks: DevicePeaks) -> float:
        return self.flops / max(seconds, 1e-12) / peaks.bf16_flops

    def hbm_util(self, seconds: float, peaks: DevicePeaks) -> float:
        return self.bytes_accessed / max(seconds, 1e-12) / peaks.hbm_bytes


def cost_of(jitted, *args, **kwargs) -> ProgramCost:
    """XLA cost analysis of a jitted callable at the given args. Compiles
    (persistent-cache warm) but does not execute."""
    ca = jitted.lower(*args, **kwargs).compile().cost_analysis()
    return ProgramCost(
        flops=float(ca.get("flops", 0.0)),
        bytes_accessed=float(ca.get("bytes accessed", 0.0)),
    )


def summarize(label: str, cost: ProgramCost, seconds: float,
              power_w: float, peaks: DevicePeaks | None = None) -> str:
    """One line of cost and time; MFU and bandwidth shares only when the
    card's power limit `power_w` is the one the peaks assume."""
    p = peaks or device_peaks()
    head = (
        f"{label}: {cost.flops/1e9:.1f} GFLOP, "
        f"{cost.bytes_accessed/1e9:.2f} GB device memory, "
        f"{seconds*1e3:.1f} ms"
    )
    if abs(power_w - p.power_w) > 1.0:
        return (
            f"{head}; no MFU or bandwidth share: the card is limited to "
            f"{power_w:.0f} W and the peaks of {p.name} hold at "
            f"{p.power_w:.0f} W"
        )
    return (
        f"{head} -> "
        f"{100*cost.mfu(seconds, p):.2f}% MFU / "
        f"{100*cost.hbm_util(seconds, p):.1f}% memory bw "
        f"({p.name} at {p.power_w:.0f} W: {p.bf16_flops/1e12:.0f} TFLOP/s "
        f"bf16, {p.hbm_bytes/1e12:.2f} TB/s)"
    )
