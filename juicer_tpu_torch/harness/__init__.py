"""Task loaders, benches, profilers and the batch tester of the port."""

from __future__ import annotations

import subprocess


def card_line(device="cuda") -> str:
    """The device a number was measured on: the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` gives them, or
    "cpu" for a device that is not a card."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
