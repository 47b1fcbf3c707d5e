"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) for sm_90a.

Each source is compiled by its own ``nvcc`` into a shared library with a plain
C interface, all sources at once in parallel, and loaded with ``ctypes``. The
libraries go into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing is built when a module is
imported: ``library()`` builds on first use, i.e. on the first CUDA launch.

No ``--use_fast_math``: the front kernel's bin indices must match the plain
version's f32 arithmetic exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("front_fused", "flash_attention", "decoder_head",
           "flash_attention_train", "sam_attention", "encoder_stats", "stats_head",
           "decoder_head_v3", "probes", "sam_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def header_constant(header: str, name: str) -> int:
    """The value of ``constexpr int name = <integer>;`` in ``csrc/<header>``,
    so that a wrapper sizes its launch grid and scratch from the constants
    the kernel is compiled with instead of restating them."""
    text = (CSRC / header).read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    if found is None:
        raise LookupError(f"csrc/{header} declares no `constexpr int {name} = <integer>;`")
    return int(found.group(1))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all(names=SOURCES) -> float:
    """Compile every missing library (one nvcc per source, in parallel) and
    load them all. Returns the seconds spent compiling."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}_{_digest(name)}.so"))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all((name,))
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        fn = getattr(lib, f"voxactb_{name}_error_string")
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"CUDA kernel {name} failed: {fn(err).decode()} ({err})")


def stream_ptr(device) -> int:
    """The handle of the current CUDA stream of ``device`` (a torch.device),
    as ``torch.cuda.current_stream(device).cuda_stream`` gives it. The raw
    accessor, where the build has it, skips making a Stream object, a
    noticeable share of a launch's host time."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if device.index is None else device.index)


def entry(name: str, symbol: str, argtypes) -> tuple:
    """The library ``name``'s C entry point ``symbol`` with its argument types
    set (once per loaded library): ``(library, function)``."""
    lib = library(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, fn


def tma_operand(t):
    """Contiguous and 16-byte aligned, as a TMA tensor map needs it."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


_SMS: Dict[object, int] = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device (cached by the device as given)."""
    if device not in _SMS:
        import torch

        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]
