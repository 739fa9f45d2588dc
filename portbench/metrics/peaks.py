"""Published peaks of NVIDIA's H100 parts (data sheets, dense rates, at
the full power limit), by part name.  Copied from the port's
`chip_smoke.py` (`PEAKS`, `PEAKS_BF16`, `peaks_for`); TF32 is half the
bf16 tensor-core rate, as the data sheets give it."""
from __future__ import annotations

HBM = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}        # bytes/s
FLOPS = {"f32": {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12},
         "tf32": {"PCIe": 378e12, "NVL": 417.5e12, "SXM": 495e12},
         "bf16": {"PCIe": 756e12, "NVL": 835e12, "SXM": 989e12}}


def part(device_name: str) -> str:
    """'H100 PCIe' and 'H100 NVL' by name; every other H100 (the
    'H100 80GB HBM3' of the SXM boards) is the SXM part."""
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return key
    return "SXM"


def hbm(device_name: str) -> float:
    return HBM[part(device_name)]


def flops(device_name: str, precision: str) -> float:
    return FLOPS[precision][part(device_name)]
