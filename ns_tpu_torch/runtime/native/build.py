"""Lazy g++ build of the native runtime library.

Port of `ns_tpu/runtime/native/build.py`. Compiles the port's copy of the
writer, `ns_tpu_torch/csrc/stream_writer.cpp`, into
`ns_tpu_torch/_build/_ns_native.so` on first use (one `g++ -O2 -shared
-fPIC -pthread` invocation, ~1 s, rebuilt when the source is newer than the
library). It never builds next to the source and never loads the JAX
package's library. The library exposes a plain C ABI consumed via ctypes
(ns_tpu_torch/io/native_writer.py). Callers treat a `None` return as "no
native path": `AsyncNpyWriter`'s 'auto' backend then takes the Python
thread writer, a host I/O choice that touches no kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_PKG, "csrc", "stream_writer.cpp")
_SO = os.path.join(_PKG, "_build", "_ns_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    # per-process tmp name: processes that build at once (several on a
    # cold cache) must not interleave g++ output into one shared tmp file —
    # a corrupt .so would look fresh to the mtime check forever
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        # g++ may have created (part of) the tmp before failing/timing
        # out; don't litter one orphan per failed process
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _SO)  # atomic against a concurrent build
    return True


def load():
    """Return the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # a built .so without its source is valid (None only when no
        # native path exists) — rebuild only when the source is present
        # and newer
        stale = (not os.path.exists(_SO)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SO) < os.path.getmtime(_SRC)))
        if stale and not _compile():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.nsio_open.restype = ctypes.c_void_p
        lib.nsio_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint64]
        lib.nsio_submit.restype = ctypes.c_int
        lib.nsio_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_void_p, ctypes.c_uint64]
        lib.nsio_sync.restype = ctypes.c_int
        lib.nsio_sync.argtypes = [ctypes.c_void_p]
        lib.nsio_close.restype = ctypes.c_int
        lib.nsio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
