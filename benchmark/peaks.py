"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 (the data sheet; dense rates, at the card's full power
limit of 700 W): 3.35 TB/s of HBM3 bandwidth, 67 TFLOP/s in float32
outside the tensor cores.  A card set below 700 W runs slower under load:
the run prints its power limit beside the shares.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peak(NamedTuple):
    bytes_per_s: float
    fp32_flops_per_s: float


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(3.35e12, 67e12),
}


def lookup(kind: str) -> Optional[Peak]:
    return PEAKS.get(kind)
