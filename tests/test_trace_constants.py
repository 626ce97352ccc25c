"""Module-level constants must not be JAX values.

A `jnp` constant made at import time becomes a tracer when its module is
first imported inside a trace (a lazy import in a jitted body). That
tracer leaks into every later trace that closes over it as an extra
executable argument, which JAX's C++ dispatch path does not supply: the
second call of a new shape then fails with "Execution supplied N buffers
but compiled program expected N+1" (CPU) or "Executable expected N+1
arguments but got N" (GPU). Each check runs in a fresh interpreter, since
the fault depends on which trace imports the module first.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_no_module_level_jax_values_when_imported_in_a_trace():
    code = """
import importlib, importlib.util, json, pkgutil, sys
import jax, jax.numpy as jnp
import allpathslg_tpu
mods = sorted(m.name for m in pkgutil.walk_packages(
    allpathslg_tpu.__path__, "allpathslg_tpu.")
    if importlib.util.find_spec(m.name).origin.endswith(".py"))
def body(x):
    for m in mods:
        importlib.import_module(m)
    return x + 1
jax.jit(body)(jnp.zeros(2))
bad = [f"{m}.{k}" for m in mods for k, v in vars(sys.modules[m]).items()
       if isinstance(v, (jax.core.Tracer, jax.Array))]
print(json.dumps([len(mods), bad]))
"""
    n_mods, bad = json.loads(_run(code))
    assert n_mods > 40
    assert bad == []


def test_gapped_rescue_new_shapes_after_lazy_dp_import():
    """The failure seen in the polish stage: ops.banded first imported
    inside _gapped_rescue's trace, then a second shape called twice."""
    code = """
import json, sys
import jax, jax.numpy as jnp
from allpathslg_tpu.align import lookup as lk
assert "allpathslg_tpu.ops.banded" not in sys.modules
def args(N, L, T):
    return (jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32),
            jnp.zeros(N, bool), jnp.zeros(N, bool), jnp.zeros(T, jnp.uint8),
            jnp.array([0, T // 2, T], jnp.int32), jnp.zeros((N, L), jnp.uint8),
            jnp.full(N, L, jnp.int32))
costs = []
for shp in [(64, 26, 500), (32, 40, 700), (32, 40, 700), (32, 40, 700)]:
    ok, cost = lk._gapped_rescue(*args(*shp), lk.AlignConfig())
    costs.append(int(cost.max()))
print(json.dumps(costs))
"""
    assert len(json.loads(_run(code))) == 4
