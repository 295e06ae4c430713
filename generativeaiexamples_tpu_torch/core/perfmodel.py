"""Analytic FLOP / HBM-byte models that the live device-time ledger
(observability/devtime.py), the host KV tier's eviction pricing
(engine/kv_tier.py) and the engine watchdog's dispatch bound compute from.

Port of ``generativeaiexamples_tpu/core/perfmodel.py``. Everything here is
first-principles arithmetic over public model facts:

  * decoder-only transformer FLOPs ≈ ``2 · n_params`` per processed token
    (the forward matmuls touch every weight once; attention-score FLOPs are
    a small correction at serving context lengths and are deliberately
    excluded);
  * decode is weight-read-bound: every decode step re-reads the full
    weight set, so weight-read HBM traffic is ``steps · param_bytes`` with
    ``param_bytes`` the quant-aware resident weight footprint;
  * card peaks are the published dense bf16 tensor-core FLOP/s and HBM
    bandwidth (``CHIP_PEAKS``), keyed by a substring of
    ``torch.cuda.get_device_name``. The port holds one card's: the H100
    SXM5 (``nvidia-smi``: "NVIDIA H100 80GB HBM3", power limit 700.00 W),
    989e12 bf16 FLOP/s and 3.35e12 B/s — the peaks ``chip_smoke.py``'s
    bounds use. A card run below its power limit reaches less.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# dense bf16 tensor-core peak (FLOP/s) and HBM bandwidth (B/s) per card,
# keyed by a substring of torch.cuda.get_device_name
CHIP_PEAKS = {
    "H100": (989e12, 3.35e12),     # H100 SXM5 80GB HBM3, 700 W
}


def chip_peaks(device) -> Tuple[Optional[float], Optional[float]]:
    """(peak_flops, peak_hbm_bw) for a ``torch.device``; (None, None) on
    the CPU or an unknown card — callers must treat utilization as
    unreportable then, never as zero."""
    if device is None:
        return (None, None)
    kind = getattr(device, "type", str(device))
    if kind != "cuda":
        return (None, None)
    import torch

    try:
        name = torch.cuda.get_device_name(device)
    except (RuntimeError, AssertionError):
        return (None, None)
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return peaks
    return (None, None)


def decode_flops(n_params: int, tokens: float) -> float:
    """Model FLOPs to process ``tokens`` token positions (prefill or
    decode): 2 FLOPs per parameter per token."""
    return 2.0 * float(n_params) * float(tokens)


def weight_bytes(n_params: int, quant: str, dtype_itemsize: int) -> float:
    """Resident weight footprint in bytes — what one full weight read
    (one decode step) streams from HBM. int8 weight-only quantization
    stores 1 byte/param (per-channel scales are noise next to the weights
    and excluded)."""
    return float(n_params) * (1 if quant == "int8" else int(dtype_itemsize))


@dataclass(frozen=True)
class PerfModel:
    """One model-on-one-card analytic envelope: FLOPs, weight bytes, peaks.

    ``mfu``/``hbm_read_util`` return None (not 0.0) when the card's peaks
    are unknown — an unknown denominator must never masquerade as an idle
    card."""

    n_params: int
    param_bytes: float
    peak_flops: Optional[float] = None
    peak_bw: Optional[float] = None

    @classmethod
    def build(cls, n_params: int, quant: str, dtype_itemsize: int,
              device=None) -> "PerfModel":
        peak_flops, peak_bw = chip_peaks(device)
        return cls(n_params=int(n_params),
                   param_bytes=weight_bytes(n_params, quant, dtype_itemsize),
                   peak_flops=peak_flops, peak_bw=peak_bw)

    def flops(self, tokens: float) -> float:
        return decode_flops(self.n_params, tokens)

    def weight_read_bytes(self, weight_passes: float) -> float:
        """HBM bytes streamed by ``weight_passes`` full weight reads (one
        per decode step; grouped prefill pays one per dispatch)."""
        return float(weight_passes) * self.param_bytes

    def prefill_seconds(self, tokens: float) -> Optional[float]:
        """Lower-bound device seconds to prefill ``tokens`` positions at
        the card's matmul peak — the recompute cost a cached KV prefix
        saves, and therefore the value basis for the prefix tier's
        eviction pricing (engine/kv_tier.py). None when the card's peaks
        are unknown — the tier falls back to a token-count proxy, never
        to pricing every entry at zero."""
        if not self.peak_flops:
            return None
        return self.flops(tokens) / self.peak_flops

    def mfu(self, tokens: float, seconds: float) -> Optional[float]:
        """Achieved model-FLOP utilization of ``tokens`` positions computed
        in ``seconds`` of device time."""
        if not self.peak_flops or seconds <= 0:
            return None
        return self.flops(tokens) / seconds / self.peak_flops

    def hbm_read_util(self, weight_passes: float,
                      seconds: float) -> Optional[float]:
        """Fraction of peak HBM bandwidth consumed by weight re-reads."""
        if not self.peak_bw or seconds <= 0:
            return None
        return self.weight_read_bytes(weight_passes) / seconds / self.peak_bw
