"""What a measurement ran on: JAX's device and, on NVIDIA cards, the
name and power limit nvidia-smi reports (a card set below its maximum
power runs slower under load, so every number is kept beside them)."""

from __future__ import annotations

import shutil
import subprocess

__all__ = ["nvidia_smi_name_power", "device_info"]


def nvidia_smi_name_power():
    """`name, power.limit` of each card as one line per card, or None
    when nvidia-smi is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_info():
    """{'platform', 'kind', 'count'} as JAX reports the default devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
