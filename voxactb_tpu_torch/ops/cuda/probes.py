"""P1-P3: the TPU measurement probes of ``tools/`` as Hopper kernels.

- ``grid_copy`` replaces ``tools/profile_stages.py::grid_copy``: ``out = x``
  for a contiguous ``[B, N, H, W, C]`` grid, slab of ``rows`` rows by slab,
  each slab streamed through shared memory in chunks by the bulk copy unit
  (``csrc/probes.cu``). Bound by bytes: d0 at 100^3 is 128 MB read and 128 MB
  written.
- ``smem_scratch`` replaces ``tools/probe_vmem.py::probe_scratch``: row 0 of
  ``x [8, 128]`` f32 through a shared-memory scratch of ``nbytes`` into row 0
  of the output. Hopper has no VMEM; the launch fails past the card's opt-in
  shared memory per block, and the wrapper raises then.
- ``shifted_window`` replaces ``tools/probe_vmem.py::probe_shifted_einsum``:
  the 3 x 3 (9-tap) valid-window matmul of a padded ``[H+2, W+2, 128]`` bf16
  block with ``w [9, 128, 64]`` bf16 into ``[H, W, 64]`` f32, an implicit GEMM
  on ``mma.sync``.

Each wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import header_constant

CHUNK_BYTES = header_constant("probes.cu", "kChunkBytes")  # one bulk copy
_COPY_CTAS_PER_SM = header_constant("probes.cu", "kCopyCtasPerSm")
SCRATCH_ROW_BYTES = 128 * 4  # one row of x: 128 f32
_SW_C, _SW_N, _SW_TAPS = (header_constant("probes.cu", k) for k in ("kSwC", "kSwN", "kSwTaps"))


# -- P1 grid_copy ---------------------------------------------------------------


def grid_copy_plan(n_slabs: int, slab_bytes: int, sms: int):
    """``(ctas_per_slab, chunks_per_cta)`` of the copy kernel: a slab is
    ``ceil(slab_bytes / CHUNK_BYTES)`` chunks, split into runs of
    ``chunks_per_cta`` over ``ctas_per_slab`` CTAs, with as many CTAs per slab
    as keep ``kCopyCtasPerSm`` per SM (one wave) and at least one."""
    chunks = -(-slab_bytes // CHUNK_BYTES)
    want = max(1, min(chunks, _COPY_CTAS_PER_SM * sms // n_slabs))
    per = -(-chunks // want)
    return -(-chunks // per), per


def grid_copy_chunks(n_slabs: int, slab_bytes: int, sms: int):
    """The kernel's schedule in plain Python: for every CTA in launch order,
    its ``(byte offset, bytes)`` copies in order, as ``csrc/probes.cu``
    computes them."""
    ctas, per = grid_copy_plan(n_slabs, slab_bytes, sms)
    out = []
    for cta in range(n_slabs * ctas):
        slab, part = divmod(cta, ctas)
        first = part * per * CHUNK_BYTES
        copies = []
        for i in range(per):
            start = first + i * CHUNK_BYTES
            if start >= slab_bytes:
                break
            copies.append((slab * slab_bytes + start,
                           min(CHUNK_BYTES, slab_bytes - start)))
        out.append(copies)
    return out


def grid_copy_reference(x: torch.Tensor, rows_per_step: int = 1) -> torch.Tensor:
    """Plain version: a copy of ``x``."""
    del rows_per_step
    return x.clone()


def _slabs(x: torch.Tensor, rows_per_step: int):
    if x.dim() != 5:
        raise ValueError(f"grid_copy takes a [B,N,H,W,C] grid, got {tuple(x.shape)}")
    b, n = x.shape[:2]
    if rows_per_step < 1 or n % rows_per_step:
        raise ValueError(f"grid_copy: N = {n} must divide by rows_per_step = {rows_per_step}")
    slab_bytes = x[0, :rows_per_step].numel() * x.element_size()
    if slab_bytes % 16:
        raise ValueError(f"grid_copy's bulk copies move 16-byte multiples; a slab of "
                         f"{rows_per_step} rows of {tuple(x.shape)} {x.dtype} is "
                         f"{slab_bytes} bytes")
    return b * n // rows_per_step, slab_bytes


def launch_grid_copy(x: torch.Tensor, out: torch.Tensor, rows_per_step: int,
                     n_slabs=None) -> None:
    """The kernel on CUDA tensors: copy the first ``n_slabs`` slabs (all by
    default) of ``x`` into ``out``, a tensor of the same shape and dtype."""
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr

    total, slab_bytes = _slabs(x, rows_per_step)
    n_slabs = total if n_slabs is None else n_slabs
    if (out.shape != x.shape or out.dtype != x.dtype or not x.is_contiguous()
            or not out.is_contiguous() or x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("grid_copy takes contiguous, 16-byte aligned x and out of one "
                         "shape and dtype")
    ctas, per = grid_copy_plan(total, slab_bytes, sm_count(x.device))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("probes", "voxactb_grid_copy", [vp, vp, ctypes.c_longlong, ci, ci, ci, vp])
    err = fn(x.data_ptr(), out.data_ptr(), slab_bytes, n_slabs, ctas, per,
             stream_ptr(x.device))
    check(lib, "probes", err)
    LAUNCHES["grid_copy"] += 1


def grid_copy(x: torch.Tensor, rows_per_step: int) -> torch.Tensor:
    """``x`` copied slab by slab of ``rows_per_step`` rows; N must divide by
    it, as in the TPU kernel. CPU tensors take the plain version."""
    _slabs(x, rows_per_step)
    if not x.is_cuda:
        return grid_copy_reference(x, rows_per_step)
    from voxactb_tpu_torch.ops.cuda.build import tma_operand

    x = tma_operand(x)  # contiguous, 16-byte aligned
    out = torch.empty_like(x)
    launch_grid_copy(x, out, rows_per_step)
    return out


# -- P2 smem_scratch --------------------------------------------------------------


def _scratch_operands(x: torch.Tensor, nbytes: int):
    if x.shape != (8, 128) or x.dtype != torch.float32:
        raise ValueError(f"smem_scratch takes x [8, 128] f32, got {tuple(x.shape)} {x.dtype}")
    if nbytes < SCRATCH_ROW_BYTES or nbytes % 4:
        raise ValueError(f"the scratch holds at least one row ({SCRATCH_ROW_BYTES} bytes) "
                         f"of f32; got {nbytes} bytes")


def smem_scratch_reference(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Plain version: row 0 of ``x`` through a scratch tensor of ``nbytes``
    into row 0 of the output; rows 1-7 are left unwritten, as the TPU kernel
    leaves them. It always succeeds."""
    _scratch_operands(x, nbytes)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    scratch[:128] = x[0]
    out = torch.empty_like(x)
    out[0] = scratch[:128]
    return out


def smem_scratch(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Same arguments and return as ``smem_scratch_reference``. On a CUDA
    tensor the kernel takes a dynamic shared-memory scratch of ``nbytes``;
    past the card's opt-in limit per block the launch is refused and this
    raises ``RuntimeError``."""
    if not x.is_cuda:
        return smem_scratch_reference(x, nbytes)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

    _scratch_operands(x, nbytes)
    x = x.contiguous()
    out = torch.empty_like(x)
    vp = ctypes.c_void_p
    lib, fn = entry("probes", "voxactb_smem_scratch", [vp, vp, ctypes.c_int, vp])
    err = fn(x.data_ptr(), out.data_ptr(), nbytes, stream_ptr(x.device))
    check(lib, "probes", err)
    LAUNCHES["smem_scratch"] += 1
    return out


def smem_optin(device) -> int:
    """The card's shared memory per block with the opt-in, from the CUDA
    runtime's attribute query: the largest scratch ``smem_scratch`` takes."""
    from voxactb_tpu_torch.ops.cuda.build import entry

    dev = torch.device(device)
    _, fn = entry("probes", "voxactb_smem_optin", [ctypes.c_int])
    return fn(torch.cuda.current_device() if dev.index is None else dev.index)


# -- P3 shifted_window --------------------------------------------------------------


def _window_operands(x: torch.Tensor, w: torch.Tensor):
    if (x.dim() != 3 or x.shape[-1] != _SW_C or min(x.shape[:2]) < 3
            or w.shape != (_SW_TAPS, _SW_C, _SW_N)):
        raise ValueError(f"shifted_window takes x [H+2, W+2, {_SW_C}] and w [{_SW_TAPS}, "
                         f"{_SW_C}, {_SW_N}]; got {tuple(x.shape)}, {tuple(w.shape)}")
    return x.shape[0] - 2, x.shape[1] - 2


def shifted_window_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the sum over taps (dy, dx) in row-major order of
    ``x[dy:dy+H, dx:dx+W].float() @ w[3 dy + dx].float()`` -> ``[H, W, 64]``
    f32, as the JAX probe's own numpy reference."""
    h, wd = _window_operands(x, w)
    out = torch.zeros((h, wd, _SW_N), dtype=torch.float32, device=x.device)
    for t in range(_SW_TAPS):
        dy, dx = divmod(t, 3)
        out += x[dy:dy + h, dx:dx + wd].float() @ w[t].float()
    return out


def shifted_window(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same arguments and return as ``shifted_window_reference``; CPU tensors
    take the plain version, CUDA tensors the kernel (bf16 operands)."""
    if not x.is_cuda:
        return shifted_window_reference(x, w)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr, tma_operand

    h, wd = _window_operands(x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the shifted_window kernel takes bf16 operands; got {x.dtype}, "
                         f"{w.dtype}")
    x, w = tma_operand(x), tma_operand(w)  # contiguous, 16-byte aligned
    out = torch.empty((h, wd, _SW_N), dtype=torch.float32, device=x.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("probes", "voxactb_shifted_window", [vp, vp, vp, ci, ci, vp])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, stream_ptr(x.device))
    check(lib, "probes", err)
    LAUNCHES["shifted_window"] += 1
    return out
