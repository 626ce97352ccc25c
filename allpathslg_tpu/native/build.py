"""Build + load the native host extensions (C++ via ctypes).

The C ABI + ctypes keeps the toolchain to a bare `g++ -O3 -shared -fPIC`.
Libraries build from the .cpp sources lazily into the package directory on
first use (they are not committed: `-march=native` ties them to the host
that built them) and are cached; absence of a compiler degrades to the
pure-Python fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS = {}


def _build(name: str) -> Optional[str]:
    src = os.path.join(_DIR, name + ".cpp")
    so = os.path.join(_DIR, name + ".so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    # a per-call temp name: concurrent builders (test workers) must not
    # write into each other's output before the atomic rename
    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix=name + ".", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o",
             tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(name: str) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = _build(name)
        lib = ctypes.CDLL(so) if so else None
        _LIBS[name] = lib
        return lib


def radix_lib() -> Optional[ctypes.CDLL]:
    lib = load("radix_sort")
    if lib is None:
        return None
    lib.radix_sort_u64.restype = ctypes.c_int
    lib.radix_sort_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64]
    return lib


def sort_u64_with_payload(keys, payload):
    """Stable parallel sort of uint64 keys with an int64 payload, in place.
    Falls back to numpy argsort when the native library is unavailable.
    Returns (keys, payload) sorted."""
    import numpy as np
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    payload = np.ascontiguousarray(payload, dtype=np.int64)
    lib = radix_lib()
    if lib is None or len(keys) < (1 << 14):
        order = np.argsort(keys, kind="stable")
        return keys[order], payload[order]
    lib.radix_sort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(keys)))
    return keys, payload


def fastq_lib() -> Optional[ctypes.CDLL]:
    lib = load("fastq_reader")
    if lib is None:
        return None
    lib.fastq_scan.restype = ctypes.c_int
    lib.fastq_scan.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_long),
                               ctypes.POINTER(ctypes.c_long)]
    lib.fastq_load.restype = ctypes.c_int
    lib.fastq_load.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_ubyte),
                               ctypes.POINTER(ctypes.c_ubyte),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.c_long, ctypes.c_long]
    return lib
