"""Kernel tuning registry.

Device-kernel variant choices (e.g. flat lax.sort vs bucketed grouping for
k-mer counting) are performance-equivalent in semantics but not in speed,
and the winner depends on the chip generation and XLA version. Choices are
measured once on the target hardware (scripts/tune_count.py) and persisted
to an UNTRACKED per-user file (`$APLG_TUNING_FILE`, default
`~/.cache/allpathslg_tpu/kernel_tuning.json`); the `kernel_tuning.json`
committed next to this module holds repo defaults only and is never written
at runtime. The env var `APLG_COUNT_ENGINE=flat|bucketed` overrides both.

Scope note: "count_engine" currently routes the single-batch spectrum entry
point (`kmer.count.spectrum_reads_auto`, used by bench.py and tests); the
pipeline's production counting paths are the streamed
`count_reads_streaming` family, which has one engine (flat sort+merge) —
the bucketed engine has no streaming form (ROADMAP C3 decides its fate on
the GPU).

(ref: the reference hard-codes its analogous choices per build — e.g.
naif_kmer pass counts sized to L2; here the registry replaces recompiling.)
"""

from __future__ import annotations

import functools
import json
import os

_REPO_DEFAULTS_FILE = os.path.join(os.path.dirname(__file__),
                                   "kernel_tuning.json")

DEFAULTS = {
    # k-mer counting/spectrum engine: "flat" = one global lax.sort;
    # "bucketed" = batched row sorts + quantile buckets (ops/bucket_count.py)
    "count_engine": "flat",
}


def _user_file() -> str:
    env = os.environ.get("APLG_TUNING_FILE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "allpathslg_tpu", "kernel_tuning.json")


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    cur = dict(DEFAULTS)
    for path in (_REPO_DEFAULTS_FILE, _user_file()):
        try:
            with open(path) as f:
                cur.update(json.load(f))
        except Exception:
            pass
    return cur


def get(key: str) -> str:
    env = os.environ.get("APLG_" + key.upper())
    if env:
        return env
    return _load().get(key, DEFAULTS[key])


def save(updates: dict) -> str:
    """Persist measured winners to the per-user tuning file (never the
    repo checkout — a chip-specific winner is not a universal default)."""
    path = _user_file()
    cur = {}
    try:
        with open(path) as f:
            cur = json.load(f)
    except Exception:
        pass
    cur.update(updates)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cur, f, indent=1, sort_keys=True)
    _load.cache_clear()
    return path
