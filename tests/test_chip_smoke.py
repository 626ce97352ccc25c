"""chip_smoke.py's phases at toy size on the CPU, and its refusal to run
without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.device_phase()


@pytest.mark.parametrize("rule", ["window", "rescue"])
def test_make_problems_shapes(rule):
    q, ql, t, tl, off = cs.make_problems(64, 40, 56, 8, rule)
    assert q.shape == (64, 40) and t.shape == (64, 56)
    assert q.dtype == t.dtype == np.uint8 and q.max() <= 4
    assert ((ql >= 20) & (ql <= 40)).all() and ((tl >= 40) & (tl <= 56)).all()
    # query positions beyond q_len are padding
    assert (q[np.arange(40)[None, :] >= ql[:, None]] == 4).all()
    if rule == "rescue":
        assert (off == 8).all() and (tl == 56).all()


def test_dp_phase_toy():
    rows = cs.dp_phase(shapes=(("toy", 130, 40, 56, 8, "window"),
                               ("toy_rescue", 64, 33, 49, 8, "rescue")),
                       reps=1, n_check=8)
    assert [r["checked"] for r in rows] == [8, 8]
    assert all(r["feasible"] > 0 for r in rows)


@pytest.mark.gpu
def test_dp_phase_on_gpu():
    """On a card: the compiled DP at a product shape equals the oracle."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    rows = cs.dp_phase(shapes=(cs.DP_SHAPES[1],), reps=2, n_check=16)
    assert rows[0]["checked"] == 16


def test_main_path_phase_toy(tmp_path):
    r = cs.main_path_phase(str(tmp_path / "run"), 20000, coverage=40.0,
                           jump_coverage=20.0, error_rate=0.005, seed=11,
                           batch_reads=4096)
    assert r["misassembly_breaks"] == 0
    assert r["genome_covered_frac"] >= 0.99
    assert {"precorrect", "align_frags", "polish", "evaluate"} <= set(
        r["stage_s"])
    assert r["peak_device_bytes"] is None   # the CPU keeps no such count


def test_check_assembly_rejects_short_assembly():
    class FakeRun:
        def metrics(self, stage):
            return {"evaluate": {"misassembly_breaks": 0,
                                 "genome_covered_frac": 1.0},
                    "make_scaffolds": {"scaffold_n50": 900}}[stage]

    with pytest.raises(AssertionError, match="0.95-1.10x"):
        cs.check_assembly(FakeRun(), {"total_bases": 500}, 1000)


@pytest.mark.parametrize("n50,ok", [(100_000, False), (600_000, True)])
def test_check_assembly_contig_n50_at_1mb(n50, ok):
    """At >= 1 Mb the contig N50 must exceed 100 kb (the 1 Mb scale
    test's threshold), besides the scaffold N50 rule."""
    G = 1_000_000

    class FakeRun:
        def metrics(self, stage):
            return {"evaluate": {"misassembly_breaks": 0,
                                 "genome_covered_frac": 1.0},
                    "make_scaffolds": {"scaffold_n50": G}}[stage]

    report = {"total_bases": G, "n50": n50}
    if ok:
        assert cs.check_assembly(FakeRun(), report, G)["total_bases"] == G
    else:
        with pytest.raises(AssertionError, match="contig N50"):
            cs.check_assembly(FakeRun(), report, G)
