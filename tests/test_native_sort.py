"""Native C++ parallel radix sort vs numpy."""

import numpy as np
import pytest

from allpathslg_tpu.native import build


def test_native_lib_builds():
    lib = build.radix_lib()
    if lib is None:
        pytest.skip("no g++ available")


def test_radix_matches_numpy_stable():
    rng = np.random.default_rng(0)
    n = 1 << 17
    keys = rng.integers(0, 1 << 48, n, dtype=np.uint64)
    # duplicates to exercise stability
    keys[::7] = keys[0]
    pay = np.arange(n, dtype=np.int64)
    ks, ps = build.sort_u64_with_payload(keys.copy(), pay.copy())
    order = np.argsort(keys, kind="stable")
    assert (ks == keys[order]).all()
    assert (ps == pay[order]).all()


def test_radix_small_falls_back():
    keys = np.asarray([3, 1, 2], np.uint64)
    pay = np.asarray([0, 1, 2], np.int64)
    ks, ps = build.sort_u64_with_payload(keys, pay)
    assert ks.tolist() == [1, 2, 3]
    assert ps.tolist() == [1, 2, 0]


def test_radix_large_keys_and_zero_bytes():
    rng = np.random.default_rng(1)
    n = 1 << 16
    # keys confined to low 16 bits: high-byte passes must be skipped safely
    keys = rng.integers(0, 1 << 16, n, dtype=np.uint64)
    pay = np.arange(n, dtype=np.int64)
    ks, ps = build.sort_u64_with_payload(keys.copy(), pay.copy())
    order = np.argsort(keys, kind="stable")
    assert (ks == keys[order]).all()
    assert (ps == pay[order]).all()


def test_concurrent_builds_do_not_collide(tmp_path, monkeypatch):
    """Concurrent builders (test workers) each write a private temp file
    and rename it into place; no temp file is left behind."""
    import shutil
    import threading

    if shutil.which("g++") is None:
        pytest.skip("no g++ available")
    shutil.copy(build.os.path.join(build._DIR, "radix_sort.cpp"), tmp_path)
    monkeypatch.setattr(build, "_DIR", str(tmp_path))
    out = []
    ts = [threading.Thread(target=lambda: out.append(build._build(
        "radix_sort"))) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    so = str(tmp_path / "radix_sort.so")
    assert out == [so] * 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "radix_sort.cpp", "radix_sort.so"]
