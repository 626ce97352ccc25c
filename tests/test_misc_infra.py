"""IntDistribution, EdgeGraph components, tools CLI smoke tests."""

import json
import numpy as np
import pytest

from allpathslg_tpu.graph.digraph import EdgeGraph, connected_components, \
    components_as_lists
from allpathslg_tpu.utils.intdist import IntDistribution


def test_intdistribution_roundtrip():
    rng = np.random.default_rng(0)
    samples = rng.normal(3000, 250, 5000).astype(int)
    d = IntDistribution.from_samples(samples)
    assert abs(d.mean() - 3000) < 30
    assert abs(d.sd() - 250) < 40
    assert abs(d.quantile(0.5) - 3000) < 40


def test_intdistribution_mle_gap():
    rng = np.random.default_rng(1)
    insert = rng.normal(3000, 200, 3000).astype(int)
    d = IntDistribution.from_samples(insert)
    true_gap = 740
    spans = rng.normal(3000 - true_gap, 200, 60).astype(int)
    g, ll = d.mle_gap(spans, 0, 2000)
    assert abs(g - true_gap) < 80, g


def test_connected_components():
    rng = np.random.default_rng(2)
    # three chains + isolated vertices
    edges = [(0, 1), (1, 2), (2, 3), (10, 11), (11, 12), (20, 21)]
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    g = EdgeGraph(25, src, dst)
    lab = connected_components(g)
    assert lab[0] == lab[3] == 0
    assert lab[10] == lab[12] == 10
    assert lab[20] == lab[21] == 20
    assert lab[5] == 5  # isolated
    comps = components_as_lists(g)
    sizes = sorted(len(c) for c in comps)
    assert sizes[-3:] == [2, 3, 4]


def test_tools_cli_stats_and_search(tmp_path):
    from allpathslg_tpu import tools
    from allpathslg_tpu.io import fasta as fio
    from allpathslg_tpu.eval import sim
    from allpathslg_tpu.dtypes.reads import string_from_codes

    ref = str(tmp_path / "ref.fasta")
    g = sim.random_genome(5000, seed=3)
    fio.write_fasta(ref, [("chr", g)])
    fq = str(tmp_path / "r.fastq")
    rc = tools.main(["simulate", ref, "--out", fq, "--coverage", "5"])
    assert rc == 0
    rc = tools.main(["stats", fq])
    assert rc == 0
    rc = tools.main(["search", ref, string_from_codes(g[100:130])])
    assert rc == 0


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax
    from allpathslg_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import os
    import jax
    from allpathslg_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert path == compile_cache.enable()   # same path every call
    assert calls == [("jax_compilation_cache_dir", path),
                     ("jax_persistent_cache_min_compile_time_secs", 0.0)] * 2
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("n", [9, 64])
def test_make_mesh_raises_on_too_few_devices(n):
    import jax
    from allpathslg_tpu.parallel import mesh as pmesh

    assert len(jax.devices()) < n
    with pytest.raises(ValueError, match=f"need {n} devices"):
        pmesh.make_mesh(n)


@pytest.mark.parametrize("msg,retried", [
    ("Execution supplied 8 buffers but compiled program expected 9 buffers",
     True),
    ("INVALID_ARGUMENT: Executable expected 9 arguments but got 8", False),
])
def test_call_buffer_safe_retries_argument_mismatch(msg, retried):
    """The CPU's wording of the executable/argument race clears the
    function's cache and retries once; the GPU's wording of a mismatch is
    raised as it is (its cause is not known, so nothing hides it)."""
    from allpathslg_tpu.utils.jitsafe import call_buffer_safe

    class Fn:
        calls = cleared = 0

        def __call__(self, x):
            self.calls += 1
            if self.calls == 1:
                raise ValueError(msg)
            return x + 1

        def clear_cache(self):
            self.cleared += 1

    fn = Fn()
    if retried:
        assert call_buffer_safe(fn, 1) == 2
        assert (fn.calls, fn.cleared) == (2, 1)
    else:
        with pytest.raises(ValueError, match="Executable expected"):
            call_buffer_safe(fn, 1)
        assert (fn.calls, fn.cleared) == (1, 0)
    with pytest.raises(ValueError, match="unrelated"):
        call_buffer_safe(lambda: (_ for _ in ()).throw(
            ValueError("unrelated")))
