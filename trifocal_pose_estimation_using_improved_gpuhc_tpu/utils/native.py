"""ctypes bindings for the native data-plane parser (native/fastio.c).

The shared library is compiled on first use (cc -O2 -shared -fPIC) into
the package build directory; every caller falls back to the pure-numpy
path transparently if no compiler is available, so the native layer is an
accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_failed = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "fastio.c",
)
_SO = os.path.join(os.path.dirname(_SRC), "fastio.so")


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                # Compile to a per-process temp file and atomically rename:
                # concurrent builders (parallel tests/CLIs) then never
                # expose a half-written .so whose fresh mtime would pin the
                # broken file forever.
                tmp = f"{_SO}.{os.getpid()}.tmp"
                for cc in ("cc", "gcc", "g++", "clang"):
                    try:
                        subprocess.run(
                            [cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                            check=True, capture_output=True, timeout=60,
                        )
                        os.replace(tmp, _SO)
                        break
                    except (FileNotFoundError, subprocess.CalledProcessError):
                        continue
                else:
                    raise RuntimeError("no C compiler")
            try:
                lib = ctypes.CDLL(_SO)
            except OSError:
                # Corrupt library: drop it so the next call rebuilds
                # instead of silently falling back forever.
                os.unlink(_SO)
                raise
            lib.fastio_parse_floats.restype = ctypes.c_long
            lib.fastio_parse_floats.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
            ]
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def parse_floats(path: str) -> np.ndarray:
    """All numeric tokens in a text file as a 1-D float64 array.

    Native strtod sweep when available; numpy fallback otherwise.
    """
    lib = _load()
    if lib is None:
        # Token-skipping like the C strtod path: non-numeric tokens are
        # ignored, so both paths accept the same inputs.
        out = []
        with open(path) as f:
            for tok in f.read().split():
                try:
                    out.append(float(tok))
                except ValueError:
                    continue
        return np.array(out, np.float64)
    cap = max(os.path.getsize(path) // 2, 64)
    buf = np.empty(cap, np.float64)
    n = lib.fastio_parse_floats(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if n == -1:
        raise FileNotFoundError(path)
    if n < -1:
        cap = -n
        buf = np.empty(cap, np.float64)
        n = lib.fastio_parse_floats(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
        )
    return buf[:n].copy()
