"""Workaround for a rare XLA-CPU executable/argument mismatch race.

Under concurrent DAG stage threads (pipeline/stages.py `_run_dag`,
stage_workers>=2), a jitted function occasionally dispatches against an
executable whose parameter count is one higher than the supplied argument
buffers ("Execution supplied N buffers but compiled program expected N+1
buffers") — observed on the CPU backend for several unrelated pure
functions (align/lookup._gapped_rescue, ops/banded.banded_align) when two
shape-specializations first-compile near-simultaneously. The compiled
cache entry itself is wrong: clearing the function's jit cache and
recompiling the SAME arguments succeeds deterministically.

`call_buffer_safe` wraps a jit callable with exactly that recovery. It is
safe because every wrapped function is pure (no donation, no stateful
effects); the only cost is a recompile on the rare trip. Only the CPU
wording is retried: a mismatch on any other backend is raised as it is.

The cause found so far is repaired at its source: a module-level `jnp`
constant (ops/banded.BIG) made while its module was first imported inside
a trace became that trace's tracer, and every later trace passed it as an
extra argument that JAX's C++ dispatch path does not supply. Module
constants are numpy scalars now (tests/test_trace_constants.py).
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def _is_buffer_mismatch(e: Exception) -> bool:
    s = str(e)
    return "buffers" in s and "compiled program expected" in s


def call_buffer_safe(jit_fn, *args, **kw):
    """Call a jitted pure function; on the buffer-count mismatch race,
    clear its compilation cache and retry once (serialized)."""
    try:
        return jit_fn(*args, **kw)
    except ValueError as e:
        if not _is_buffer_mismatch(e):
            raise
        with _LOCK:
            try:
                jit_fn.clear_cache()
            except AttributeError:
                pass
            return jit_fn(*args, **kw)
