"""What the entry points print about the card they run on.

A card may be capped below its maximum power and then runs slower under
load, so every timing line names the card and its power limit as
`nvidia-smi` reports them.
"""

from __future__ import annotations

import subprocess


def nvidia_smi() -> list:
    """One `name, power.limit` line per visible GPU."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
