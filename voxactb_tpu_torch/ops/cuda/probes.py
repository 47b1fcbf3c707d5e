"""P1-P3: the TPU measurement probes of ``tools/`` as Hopper kernels.

- ``grid_copy`` replaces ``tools/profile_stages.py::grid_copy``: ``out = x``
  for a contiguous ``[B, N, H, W, C]`` grid of slabs of ``rows`` rows, cut
  into chunks that never cross a slab, which persistent CTAs take in turns
  (chunk c to CTA c mod G) and stream through shared memory by the bulk copy
  unit (``csrc/probes.cu``). Bound by bytes: d0 at 100^3 is 128 MB read and
  128 MB written.
- ``smem_scratch`` replaces ``tools/probe_vmem.py::probe_scratch``: row 0 of
  ``x [8, 128]`` f32 through a shared-memory scratch of ``nbytes`` into row 0
  of the output. Hopper has no VMEM; the launch fails past the card's opt-in
  shared memory per block, and the wrapper raises then.
- ``shifted_window`` replaces ``tools/probe_vmem.py::probe_shifted_einsum``:
  the 3 x 3 (9-tap) valid-window matmul of a padded ``[H+2, W+2, 128]`` bf16
  block with ``w [9, 128, 64]`` bf16 into ``[H, W, 64]`` f32, an implicit GEMM
  on ``wgmma``: a CTA's two warpgroups compute two 8 x 8 pixel tiles on the
  nine taps' weights, all nine requested at once.

Each wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import check, header_constant, stream_ptr

CHUNK_BYTES = header_constant("probes.cu", "kChunkBytes")  # the largest chunk
_COPY_CTAS_PER_SM = header_constant("probes.cu", "kCopyCtasPerSm")
SCRATCH_ROW_BYTES = 128 * 4  # one row of x: 128 f32
_SW_C, _SW_N, _SW_TAPS = (header_constant("probes.cu", k) for k in ("kSwC", "kSwN", "kSwTaps"))
SW_TILE = header_constant("probes.cu", "kSwTile")  # a warpgroup's tile: SW_TILE^2 pixels
_SW_CONSUMERS = header_constant("probes.cu", "kSwConsumers")  # tiles of a CTA, stacked in y


# -- P1 grid_copy ---------------------------------------------------------------


class CopyPlan(NamedTuple):
    chunk_bytes: int      # every chunk but maybe a slab's last
    chunks_per_slab: int
    ctas: int             # persistent CTAs, and the stride between a CTA's chunks


def grid_copy_plan(n_slabs: int, slab_bytes: int, sms: int, chunk_limit: int = CHUNK_BYTES,
                   ctas_per_sm: int = _COPY_CTAS_PER_SM) -> CopyPlan:
    """The copy kernel's plan: a slab is cut into the fewest chunks of at
    most ``chunk_limit`` bytes, all of one size rounded up to 16 bytes but
    the slab's last, which may be shorter; ``ctas_per_sm`` CTAs per SM in
    one wave, and no more than there are chunks."""
    per = -(-slab_bytes // chunk_limit)
    chunk = (-(-slab_bytes // per) + 15) & ~15
    per = -(-slab_bytes // chunk)
    return CopyPlan(chunk, per, max(1, min(n_slabs * per, ctas_per_sm * sms)))


def grid_copy_chunks(n_slabs: int, slab_bytes: int, sms: int, copied=None, grid=None,
                     **plan_kw):
    """The kernel's schedule in plain Python: for every CTA in launch order,
    its ``(byte offset, bytes)`` copies in order, as ``csrc/probes.cu``
    computes them, when the first ``copied`` slabs (all by default) are
    copied by ``grid`` CTAs (the plan's by default; fewer leave the chunks of
    the CTAs not launched uncopied)."""
    plan = grid_copy_plan(n_slabs, slab_bytes, sms, **plan_kw)
    n_chunks = (n_slabs if copied is None else copied) * plan.chunks_per_slab
    out = []
    for cta in range(plan.ctas if grid is None else grid):
        copies = []
        for i in range(cta, n_chunks, plan.ctas):
            slab, j = divmod(i, plan.chunks_per_slab)
            start = j * plan.chunk_bytes
            copies.append((slab * slab_bytes + start, min(plan.chunk_bytes, slab_bytes - start)))
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


class _CopyLaunch(NamedTuple):
    """What a copy launch needs besides its pointers, worked out once per
    (shape, dtype, rows, device)."""
    slabs: int
    slab_bytes: int
    plan: CopyPlan
    device: torch.device
    lib: ctypes.CDLL
    fn: object


_COPY_LAUNCHES = {}


def _copy_launch(x: torch.Tensor, rows_per_step: int) -> _CopyLaunch:
    key = (x.shape, x.dtype, rows_per_step, x.get_device())
    found = _COPY_LAUNCHES.get(key)
    if found is None:
        from voxactb_tpu_torch.ops.cuda.build import entry, sm_count

        total, slab_bytes = _slabs(x, rows_per_step)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib, prepare = entry("probes", "voxactb_grid_copy_prepare", [])
        with torch.cuda.device(x.device):
            check(lib, "probes", prepare())
        found = _COPY_LAUNCHES[key] = _CopyLaunch(
            total, slab_bytes, grid_copy_plan(total, slab_bytes, sm_count(x.device)), x.device,
            *entry("probes", "voxactb_grid_copy",
                   [vp, vp, ctypes.c_longlong, ci, ci, ci, ci, ci, vp]))
    return found


def _launch_copy(x, out, launch: _CopyLaunch, n_slabs, grid) -> None:
    plan = launch.plan
    err = launch.fn(x.data_ptr(), out.data_ptr(), launch.slab_bytes, n_slabs,
                    plan.chunk_bytes, plan.chunks_per_slab, plan.ctas, grid,
                    stream_ptr(launch.device))
    check(launch.lib, "probes", err)
    LAUNCHES["grid_copy"] += 1


def launch_grid_copy(x: torch.Tensor, out: torch.Tensor, rows_per_step: int,
                     n_slabs=None, grid=None) -> None:
    """The kernel on CUDA tensors: copy the first ``n_slabs`` slabs (all by
    default) of ``x`` into ``out``, a tensor of the same shape and dtype, on
    ``grid`` CTAs (the plan's by default; fewer leave the chunks of the last
    CTAs uncopied)."""
    launch = _copy_launch(x, rows_per_step)
    if (out.shape != x.shape or out.dtype != x.dtype or not x.is_contiguous()
            or not out.is_contiguous() or x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("grid_copy takes contiguous, 16-byte aligned x and out of one "
                         "shape and dtype")
    n_slabs = launch.slabs if n_slabs is None else n_slabs
    grid = launch.plan.ctas if grid is None else grid
    if not (0 <= n_slabs <= launch.slabs and 1 <= grid <= launch.plan.ctas):
        raise ValueError(f"grid_copy copies 0 to {launch.slabs} slabs on 1 to "
                         f"{launch.plan.ctas} CTAs; got {n_slabs} slabs, {grid} CTAs")
    _launch_copy(x, out, launch, n_slabs, grid)


def grid_copy(x: torch.Tensor, rows_per_step: int) -> torch.Tensor:
    """``x`` copied slab by slab of ``rows_per_step`` rows; N must divide by
    it, as in the TPU kernel. CPU tensors take the plain version."""
    if not x.is_cuda:
        _slabs(x, rows_per_step)
        return grid_copy_reference(x, rows_per_step)
    launch = _copy_launch(x, rows_per_step)
    if not x.is_contiguous() or x.data_ptr() % 16:
        from voxactb_tpu_torch.ops.cuda.build import tma_operand

        x = tma_operand(x)
    out = torch.empty_like(x)  # contiguous, and the allocator's blocks are aligned
    _launch_copy(x, out, launch, launch.slabs, launch.plan.ctas)
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
    from voxactb_tpu_torch.ops.cuda.build import entry

    _scratch_operands(x, nbytes)
    x = x.contiguous()
    out = torch.empty_like(x)
    vp = ctypes.c_void_p
    lib, fn = entry("probes", "voxactb_smem_scratch", [vp, vp, ctypes.c_int, vp])
    err = fn(x.data_ptr(), out.data_ptr(), nbytes, stream_ptr(x.device))
    check(lib, "probes", err)
    LAUNCHES["smem_scratch"] += 1
    return out


def empty_launch(device) -> None:
    """One launch of an empty 128-thread kernel on ``device``: the floor
    that ``smem_scratch``'s device time is held against. Counted nowhere:
    it is a yardstick, on no path."""
    from voxactb_tpu_torch.ops.cuda.build import entry

    dev = torch.device(device)
    lib, fn = entry("probes", "voxactb_empty_launch", [ctypes.c_void_p])
    check(lib, "probes", fn(stream_ptr(dev)))


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


def shifted_window_tiles(h: int, w: int):
    """The kernel's schedule: for every CTA in launch order (columns of
    tiles fastest), the first output pixel ``(row, col)`` of each of its
    warpgroups' ``SW_TILE x SW_TILE`` tiles. A CTA's tiles are stacked in y
    and share its weights. The pixels of a tile past ``(h, w)`` are computed
    on clamped inputs and not stored."""
    band = _SW_CONSUMERS * SW_TILE
    return [[(by * band + g * SW_TILE, bx * SW_TILE) for g in range(_SW_CONSUMERS)]
            for by in range(-(-h // band)) for bx in range(-(-w // SW_TILE))]


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


def launch_shifted_window(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                          wg_row_offset: int = SW_TILE) -> None:
    """The kernel on contiguous, 16-byte aligned bf16 CUDA tensors, into
    ``out [H, W, 64]`` f32. ``wg_row_offset`` is the row of the CTA's band at
    which its second warpgroup gathers its pixels: ``SW_TILE`` but in a
    planted fault (0: both warpgroups multiply the first tile's pixels)."""
    from voxactb_tpu_torch.ops.cuda.build import entry

    h, wd = _window_operands(x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the shifted_window kernel takes bf16 operands; got {x.dtype}, "
                         f"{w.dtype}")
    if (out.shape != (h, wd, _SW_N) or out.dtype != torch.float32
            or not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, w, out))):
        raise ValueError("shifted_window takes contiguous, 16-byte aligned x, w and an "
                         f"[{h}, {wd}, {_SW_N}] f32 out")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("probes", "voxactb_shifted_window", [vp, vp, vp, ci, ci, ci, vp])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, wg_row_offset,
             stream_ptr(x.device))
    check(lib, "probes", err)
    LAUNCHES["shifted_window"] += 1


def shifted_window(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same arguments and return as ``shifted_window_reference``; CPU tensors
    take the plain version, CUDA tensors the kernel (bf16 operands)."""
    if not x.is_cuda:
        return shifted_window_reference(x, w)
    from voxactb_tpu_torch.ops.cuda.build import tma_operand

    h, wd = _window_operands(x, w)
    x, w = tma_operand(x), tma_operand(w)  # contiguous, 16-byte aligned
    out = torch.empty((h, wd, _SW_N), dtype=torch.float32, device=x.device)
    launch_shifted_window(x, w, out)
    return out
