"""What the device tells the program about itself.

Batch and chunk sizes that must fit in device memory are derived from the
device's own memory limit, never from a constant sized for one card.
"""
from __future__ import annotations

import os


def device_bytes_limit(device=None) -> int:
    """Bytes this process may allocate on `device` (default: the first).

    GPUs report it as memory_stats()["bytes_limit"]. The CPU backend keeps
    arrays in host memory and reports no stats, so its limit is the host's
    physical memory. Any other device without a limit is an error: a
    default would size batches for a card the program is not running on.
    """
    import jax

    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(
        f"device {dev.device_kind!r} ({dev.platform}) reports no memory "
        "limit; batch sizes cannot be derived"
    )


def describe_device() -> dict:
    """What a measurement names its device by: JAX's platform, kind and
    count, and each card's name and power limit from nvidia-smi (a card
    set below its maximum power runs slower under load)."""
    import subprocess

    import jax

    devs = jax.devices()
    out = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if devs[0].platform == "gpu":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    return out
