"""Native runtime components (C++, bound via ctypes).

``build_native()`` compiles ``replay_store.cpp`` (the mmap ring store ``rs_*``
and the producer-thread batch sampler ``bs_*``) with g++ on first use, into
``build/native/`` at the root of the checkout (listed in ``.gitignore``), named
by a hash of the source and the flags: an edited source is rebuilt, an
unchanged one reused. Nothing is built when the module is imported.
``load_native()`` raises ``NativeBuildError`` when g++ is missing or the build
fails; there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "replay_store.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libvoxactb_native_{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Compile the native library if needed; returns the .so path."""
    lib = library_path()
    with _lock:
        if lib.exists() and not force:
            return str(lib)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename, so a process that loads the
        # library never sees a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, lib)
        except FileNotFoundError as e:
            raise NativeBuildError("g++ not available") from e
        except subprocess.CalledProcessError as e:
            raise NativeBuildError(f"native build failed:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return str(lib)


def load_native() -> ctypes.CDLL:
    """Build + dlopen with typed signatures (cached)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    path = build_native()
    lib = ctypes.CDLL(path)

    u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
    lib.rs_create.restype = vp
    lib.rs_create.argtypes = [cp, u64, u64]
    lib.rs_open.restype = vp
    lib.rs_open.argtypes = [cp]
    for name in ("rs_capacity", "rs_row_bytes", "rs_add_count", "rs_size"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [vp]
    lib.rs_add.restype = u64
    lib.rs_add.argtypes = [vp, vp]
    lib.rs_add_batch.restype = None
    lib.rs_add_batch.argtypes = [vp, vp, u64]
    lib.rs_gather.restype = None
    lib.rs_gather.argtypes = [vp, ctypes.POINTER(u64), u64, vp, ctypes.c_int]
    lib.rs_read.restype = None
    lib.rs_read.argtypes = [vp, u64, vp]
    lib.rs_flush.restype = None
    lib.rs_flush.argtypes = [vp]
    lib.rs_close.restype = None
    lib.rs_close.argtypes = [vp]
    lib.bs_start.restype = vp
    lib.bs_start.argtypes = [vp, u64, ctypes.c_int, ctypes.c_int, u64]
    lib.bs_acquire.restype = ctypes.c_int
    lib.bs_acquire.argtypes = [vp]
    lib.bs_buffer.restype = vp
    lib.bs_buffer.argtypes = [vp, ctypes.c_int]
    lib.bs_release.restype = None
    lib.bs_release.argtypes = [vp, ctypes.c_int]
    lib.bs_stop.restype = None
    lib.bs_stop.argtypes = [vp]

    with _lock:
        _lib = lib
    return lib
