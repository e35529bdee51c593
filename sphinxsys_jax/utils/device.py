"""What a measurement records about the device it ran on.

Every speed number names its device: JAX's own description of it, and the
card's name and power limit as `nvidia-smi` reports them (a card set below
its maximum power runs slower under load).  A measurement path that finds
no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """JAX's first device as {"platform", "kind", "count"}; raises
    SystemExit unless it is a GPU."""
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found only {dev.platform} "
                         f"({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def card_info() -> str:
    """`name, power.limit` of each card, one per line, from nvidia-smi (a
    child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
