"""The card a run uses: its presence, name, power limit and peaks."""
from __future__ import annotations

import subprocess


def require(chips: int) -> None:
    """Raise unless PyTorch sees at least ``chips`` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs only on the "
                           "card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out or "unknown"


def describe(device, chips: int, peak_bytes: int) -> dict:
    """The result line's ``device`` object."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak_bytes,
            "power_limit": power_limit()}


def peak_rates(table: dict, kind: str, dtype_name: str):
    """``{"bytes_per_s", "flops_per_s"}`` of the first row of the peaks
    table whose ``match`` is in the device name, or None."""
    for row in table["devices"]:
        if row["match"] in kind:
            flops = row["flops_per_s"].get(dtype_name)
            if flops is None:
                return None
            return {"bytes_per_s": row["bytes_per_s"], "flops_per_s": flops,
                    "source": row["source"]}
    return None
