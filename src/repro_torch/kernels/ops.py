"""Dispatch layer for the port's seven kernels.

Each op takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
for a tensor on the CPU and launches its hand-written CUDA kernel for a
tensor on a CUDA device. There is no fallback on the card: a shape, dtype
or layout the kernel does not take, a failed build or a launch error
raises. Host-side padding (row tiles) and the closed-loop bookkeeping of
RPIQ stage 2 live here, as in the JAX package's ``repro.kernels.ops``.

Every ``*_cuda`` wrapper adds one to its launch counter where it launches
its kernel; :func:`kernel_launches` reads the counters, so a run can show
that its main path went through the kernels. A :class:`CapturedCall`
(a CUDA graph of wrapper calls) counts each replay as the launches it
captured.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

_LAUNCHES: Dict[str, int] = {"hessian_accum": 0, "gptq_block": 0,
                             "rpiq_block": 0, "w4a16_matmul": 0,
                             "int8_kv_attention": 0, "quant_pack": 0,
                             "selective_scan": 0}


def kernel_launches() -> Dict[str, int]:
    """Copy of the per-kernel launch counters."""
    return dict(_LAUNCHES)


def reset_kernel_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _add_launches(counts: Dict[str, int], times: int) -> None:
    """Add ``times`` x ``counts`` to the counters: a CUDA graph's replays
    run the launches captured in it without passing the wrappers."""
    for k, v in counts.items():
        _LAUNCHES[k] += v * times


class CapturedCall:
    """``fn()`` captured once into a CUDA graph on the current device, then
    replayed. A capture that fails raises; nothing falls back.

    Capturing runs nothing, so the launches the wrappers counted during the
    capture are taken back and each replay counts them again. The graph's
    private memory pool keeps every tensor allocated inside ``fn`` (the
    outputs, w4a16_matmul's split-K partials) for the graph's life, and
    the object holds the int8_kv_attention workspaces in use at capture,
    which a later, larger call may replace. ``fn`` must have run once
    eagerly on the same shapes (kernel builds, library handles and the
    workspaces are made there). ``generators``: the torch.Generators ``fn``
    draws from, registered with the graph so that each replay draws new
    numbers. ``out`` is what ``fn`` returned: static tensors that each
    replay overwrites."""

    def __init__(self, fn, generators=()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = kernel_launches()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = fn()
        finally:
            after = kernel_launches()
            self.launches = {k: after[k] - before[k] for k in after}
            _add_launches(self.launches, -1)
        torch.cuda.current_stream().wait_stream(stream)
        self.workspaces = tuple(_KV_WORK.values())

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        _add_launches(self.launches, times)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _require(cond: bool, op: str, why: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {why}")


def _check_cuda(op: str, *tensors: Tensor) -> None:
    # on the decode path every call passes here: no message is formatted
    # unless a check fails
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{op}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: expected contiguous tensors")


def _launch(op: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with cudaError {err}")
    _LAUNCHES[op] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _is_plain(t: Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return True
    _require(t.device.type == "cuda", op, f"unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# H += X^T X
# ---------------------------------------------------------------------------

# the card's SMs: a launch of fewer blocks leaves some of them idle
SMS = 132
# the largest thread-block cluster every Hopper part takes
MAX_CLUSTER = 8


def hessian_accum_geometry(n: int, d: int) -> int:
    """The cluster size of the hessian_accum launch for x (n, d): each of
    the 64 x 64 upper tiles of H takes ``split`` blocks that share its
    tokens, the smallest split (1, 2, 4 or 8) that gives each SM two
    blocks, keeping at least two 32-token slabs a block. The split trades
    idle SMs for the cluster's exchange; the H100 sweep of chip_compare.py
    puts its optimum near two blocks an SM at the main paths' d."""
    nt = -(-d // 64)
    tiles = nt * (nt + 1) // 2
    most = min(MAX_CLUSTER, max(1, -(-n // 32) // 2))
    split = 1
    while split * 2 <= most and tiles * split < 2 * SMS:
        split *= 2
    return split


def hessian_accum_cuda(x: Tensor, H: Tensor) -> Tensor:
    """Kernel wrapper: accumulates XᵀX into ``H`` in place; returns H."""
    op = "hessian_accum"
    _check_cuda(op, x, H)
    _require(x.dtype == torch.float32 and H.dtype == torch.float32, op,
             "x and H must be float32")
    n, d = x.shape
    _require(H.shape == (d, d), op, f"H {tuple(H.shape)} != ({d}, {d})")
    lib = build.load(op)
    _launch(op, lib.hessian_accum_launch, x.data_ptr(), H.data_ptr(), n, d,
            hessian_accum_geometry(n, d), _stream())
    return H


def hessian_accum(x: Tensor, H: Tensor) -> Tensor:
    """``H + XᵀX`` for x (n, d) f32; on CUDA, H is updated in place."""
    if _is_plain(x, "hessian_accum"):
        return ref.hessian_accum(x, H)
    return hessian_accum_cuda(x.contiguous(), H)


# ---------------------------------------------------------------------------
# y = x @ dequant(W)^T      (W packed int4, grouped scales/zeros)
# ---------------------------------------------------------------------------

def w4a16_blocks_wanted(tile_m: int) -> int:
    """Blocks a w4a16_matmul launch should give the card: a decode block
    streams one 4 KB weight stage at a time, so four an SM keep enough of
    the weight stream in flight (the H100 sweep in PERF.md: 1.1-1.5x
    faster than one an SM at the main paths' widest decode shapes); a
    prefill block has work enough alone, one an SM."""
    return SMS * (4 if tile_m <= 16 else 1)


def w4a16_tensor_core_group(group_size: int) -> bool:
    """Whether bf16 x at this group size runs on the tensor-core kernel:
    groups of 8 and 16 (one m16n8k8 step a group of 8) and of 32, 64 or a
    multiple of 128 (a 32-column block in one group, a 128-column stage in
    one group or whole groups). The other even group sizes take the
    CUDA-core kernel."""
    return group_size in (8, 16, 32, 64) or (group_size > 0
                                              and group_size % 128 == 0)


@functools.lru_cache(maxsize=1024)
def w4a16_matmul_geometry(m: int, n: int, k: int, group_size: int = 128
                          ) -> Tuple[int, int, int, int]:
    """The bf16 tensor-core w4a16_matmul launch for x (m, k) and n weight
    rows: ``(tile_m, tile_n, splits, split_cols)``. Decode (m <= 64) takes
    blocks of 64 weight rows x 8 or 16 x rows, prefill 128 x 64 (16-row
    tiles beat 64-row ones at m 64, 64-row ones win at m 2048 on the H100:
    PERF.md). Where the tiles give the SMs fewer blocks than
    ``w4a16_blocks_wanted`` the k range is split over blocks in units of
    whole quant groups and whole 32-column blocks (the group at 32 and
    above, 32 columns at groups of 8 and 16): the most units a split that
    still gives that many blocks, down to one unit a split, then spread
    evenly over the splits."""
    tile_m = 8 if m <= 8 else 16 if m <= 64 else 64
    tile_n = 64 if tile_m <= 16 else 128
    tiles = -(-n // tile_n) * -(-m // tile_m)
    unit = math.lcm(group_size, 32)
    ng = k // unit
    want = w4a16_blocks_wanted(tile_m)
    per = max(1, min(ng, ng * tiles // want))
    splits = -(-ng // per)
    even = -(-ng // splits)
    if -(-ng // even) == splits:
        per = even
    return tile_m, tile_n, splits, per * unit


def w4a16_matmul_cuda(x: Tensor, packed: Tensor, scales: Tensor,
                      zeros: Tensor, group_size: int) -> Tensor:
    """Kernel wrapper: x (m, k) f32/bf16 → (m, n) in x.dtype; k a multiple
    of 32, any even group size dividing k.

    bf16 x at the groups of :func:`w4a16_tensor_core_group` runs on the
    tensor cores with exact products x·(c − z), which rests on the packed
    artifact's contract that every zero is an integer in [0, 15]
    (``core.quant``: asym zeros are rounded and clipped, sym zeros stored
    as 0 + 8); a zero off that grid gives a wrong product, not an error.
    fp32 x, and bf16 x at the other even group sizes, take the CUDA-core
    kernel, which dequantizes per element as the plain version does."""
    op = "w4a16_matmul"
    _check_cuda(op, x, packed, scales, zeros)
    m, k = x.shape
    n, kh = packed.shape
    # one test of every condition; the message is built only on a failure
    if not (packed.dtype == torch.uint8
            and scales.dtype == zeros.dtype == torch.float32
            and x.dtype in (torch.float32, torch.bfloat16)
            and kh * 2 == k and k % 32 == 0 and group_size > 0
            and group_size % 2 == 0 and k % group_size == 0
            and scales.shape == zeros.shape == (n, k // group_size)
            and packed.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0):
        raise ValueError(
            f"{op}: x {tuple(x.shape)} {x.dtype}, packed "
            f"{tuple(packed.shape)} {packed.dtype}, scales "
            f"{tuple(scales.shape)} {scales.dtype}, zeros "
            f"{tuple(zeros.shape)} {zeros.dtype}, group_size {group_size}: "
            "the kernels take x float32 or bfloat16 (m, k) with k a "
            "multiple of 32, uint8 packed (n, k/2), float32 scales and "
            "zeros (n, k/group_size), an even group_size dividing k, and x "
            "and packed 16-byte aligned (16-byte loads)")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.load(op)
    if x.dtype == torch.float32 or not w4a16_tensor_core_group(group_size):
        fn = (lib.w4a16_matmul_f32_launch if x.dtype == torch.float32
              else lib.w4a16_matmul_bf16_cc_launch)
        _launch(op, fn, x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), y.data_ptr(), m, n, k, group_size,
                _stream())
        return y
    tile_m, _, splits, split_cols = w4a16_matmul_geometry(m, n, k,
                                                          group_size)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    _launch(op, lib.w4a16_matmul_bf16_launch, x.data_ptr(),
            packed.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            y.data_ptr(), 0 if part is None else part.data_ptr(), m, n, k,
            group_size, tile_m, splits, split_cols, _stream())
    return y


def w4a16_matmul(x: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
                 *, group_size: int = 128) -> Tensor:
    """x: (..., k); packed: (n, k//2) u8; scales/zeros: (n, k//group_size)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _is_plain(x, "w4a16_matmul"):
        y = ref.w4a16_matmul(x2, packed, scales, zeros, group_size)
    else:
        y = w4a16_matmul_cuda(x2.contiguous(), packed, scales, zeros,
                              group_size)
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# GPTQ lazy-block sweep (stage 1)
# ---------------------------------------------------------------------------

def gptq_block_cuda(w: Tensor, hinv_u: Tensor, *, bits: int, group_size: int,
                    blocksize: int, symmetric: bool
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper: same contract as :func:`ref.gptq_block`, any
    blocksize dividing in that group_size divides. One call enqueues the
    sweep and the tail update of every lazy block (2 x in/blocksize
    kernels: ``gptq_block.cu`` keeps a block of up to 128 columns in
    registers, a wider one in place in w) and counts as one launch."""
    op = "gptq_block"
    _check_cuda(op, w, hinv_u)
    _require(w.dtype == torch.float32 and hinv_u.dtype == torch.float32, op,
             "w and hinv_u must be float32")
    b, out_dim, in_dim = w.shape
    _require(blocksize >= 1 and in_dim % blocksize == 0
             and blocksize % group_size == 0, op,
             f"in={in_dim}, blocksize={blocksize}, group_size={group_size} "
             "are not aligned")
    _require(w.data_ptr() % 16 == 0 and hinv_u.data_ptr() % 16 == 0, op,
             "w and hinv_u must be 16-byte aligned (16-byte copies)")
    lib = build.load(op)
    w_q = w.clone()
    scales = torch.empty((b, out_dim, in_dim // group_size),
                         dtype=torch.float32, device=w.device)
    zeros = torch.empty_like(scales)
    err_rows = torch.zeros((b, out_dim), dtype=torch.float32,
                           device=w.device)
    # the errors of one lazy block, transposed for the tail's vector loads
    ld_e = _round_up(out_dim, 128)
    errt = torch.empty((b, blocksize, ld_e), dtype=torch.float32,
                       device=w.device)
    _launch(op, lib.gptq_block_launch, w_q.data_ptr(), hinv_u.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), err_rows.data_ptr(),
            errt.data_ptr(), b, out_dim, in_dim, ld_e, bits, group_size,
            blocksize, int(symmetric), _stream())
    return w_q, scales, zeros, err_rows


def gptq_block(w: Tensor, hinv_u: Tensor, *, bits: int = 4,
               group_size: int = 128, blocksize: int = 128,
               symmetric: bool = False):
    """One full GPTQ sweep. w: (out, in) or (B, out, in); hinv_u matches
    with (in, in) trailing dims. Returns ``(w_q, scales, zeros, err)``
    with err the Σerr² per member."""
    squeeze = w.dim() == 2
    if squeeze:
        w, hinv_u = w[None], hinv_u[None]
    in_dim = w.shape[-1]
    _require(in_dim % blocksize == 0 and blocksize % group_size == 0,
             "gptq_block", f"in={in_dim}, blocksize={blocksize}, "
             f"group_size={group_size} are not aligned")
    kw = dict(bits=bits, group_size=group_size, blocksize=blocksize,
              symmetric=symmetric)
    w = w.float()
    hinv_u = hinv_u.float()
    if _is_plain(w, "gptq_block"):
        w_q, scales, zeros, err_rows = ref.gptq_block(w, hinv_u, **kw)
    else:
        w_q, scales, zeros, err_rows = gptq_block_cuda(
            w.contiguous(), hinv_u.contiguous(), **kw)
    out = (w_q, scales, zeros, err_rows.sum(dim=-1))
    if squeeze:
        out = tuple(o[0] for o in out)
    return out


# ---------------------------------------------------------------------------
# RPIQ closed-loop refinement (stage 2)
# ---------------------------------------------------------------------------

# output rows per rpiq_block block; ops.rpiq_block pads the row count to a
# multiple of it
RPIQ_ROWS = 32


def rpiq_block_geometry(b: int, out_dim: int, n: int) -> int:
    """The cluster size of the rpiq_block launch for B members of
    ``out_dim`` rows and n tokens: the blocks of a cluster share a row
    tile's tokens, split only while the row tiles leave more than half the
    SMs idle (a cluster's barriers and exchanges cost more than the idle
    half), keeping at least 32 tokens a block."""
    tiles = b * -(-out_dim // RPIQ_ROWS)
    split = 1
    most = min(MAX_CLUSTER, max(1, n // 32))
    while split * 2 <= most and tiles * split < SMS // 2:
        split *= 2
    return split


def rpiq_pad_rows(w0: Tensor, y_orig: Tensor, s_full: Tensor,
                  z_full: Tensor, rows: int
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pad the row count (B, out, ·) / y_orig's (B, n, out) to a multiple
    of ``rows``. Padded rows, w = 0 on an (s = 1, z = 0) grid, project to 0
    and add nothing to the residuals or the loss partials."""
    pad = _round_up(w0.shape[1], rows) - w0.shape[1]
    if not pad:
        return w0, y_orig, s_full, z_full
    F = torch.nn.functional
    return (F.pad(w0, (0, 0, 0, pad)), F.pad(y_orig, (0, pad)),
            F.pad(s_full, (0, 0, 0, pad), value=1.0),
            F.pad(z_full, (0, 0, 0, pad)))


def rpiq_block_cuda(w0: Tensor, y_orig: Tensor, x: Tensor, hinv_flat: Tensor,
                    s_full: Tensor, z_full: Tensor, *, bits: int,
                    block_size: int, alpha: float, t_max: int,
                    symmetric: bool
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper: same contract as :func:`ref.rpiq_block`, any
    block_size dividing in; the row count must be a multiple of
    RPIQ_ROWS. A block of up to 128 columns (a multiple of 4) runs the
    fused kernel, a wider one the wide path of ``rpiq_block.cu``. The fp64
    loss partials (per row tile, or per product tile on the wide path) are
    summed here, in tile order, and rounded once to fp32."""
    op = "rpiq_block"
    args = (w0, y_orig, x, hinv_flat, s_full, z_full)
    _check_cuda(op, *args)
    _require(all(a.dtype == torch.float32 for a in args), op,
             "all inputs must be float32")
    _require(all(a.data_ptr() % 16 == 0 for a in args), op,
             "inputs must be 16-byte aligned (16-byte copies)")
    b, out_dim, in_dim = w0.shape
    n = x.shape[1]
    rows, split = RPIQ_ROWS, rpiq_block_geometry(b, out_dim, n)
    _require(out_dim % rows == 0, op, f"out={out_dim} must be a multiple "
             f"of {rows} (ops.rpiq_block pads)")
    _require(t_max >= 0, op, "t_max must be >= 0")
    _require(block_size >= 1 and in_dim % block_size == 0 and n >= 1, op,
             f"block_size {block_size} must divide in={in_dim}, and n={n} "
             ">= 1")
    lib = build.load(op)
    dev = w0.device
    w_cont = torch.empty_like(w0)
    wp_all = torch.empty((b, t_max + 1, out_dim, in_dim), dtype=torch.float32,
                         device=dev)
    y_q = torch.empty((b, n, out_dim), dtype=torch.float32, device=dev)
    outs = (w_cont.data_ptr(), wp_all.data_ptr(), y_q.data_ptr())
    wide = block_size % 4 != 0 or block_size > 128
    # Γ and the projected loss, summed in fp64 per row tile (per product
    # tile on the wide path)
    parts = (lib.rpiq_block_wide_partials(n, out_dim) if wide
             else out_dim // rows)
    hist = torch.empty((b, parts, t_max + 1), dtype=torch.float64,
                       device=dev)
    pls = torch.empty_like(hist)
    if wide:
        d = torch.empty((b, n, out_dim), dtype=torch.float32, device=dev)
        rhs = torch.empty((b, block_size, out_dim), dtype=torch.float32,
                          device=dev)
        _launch(op, lib.rpiq_block_wide_launch,
                *(a.data_ptr() for a in args), *outs, hist.data_ptr(),
                pls.data_ptr(), d.data_ptr(), rhs.data_ptr(), b, out_dim,
                in_dim, n, block_size, t_max, float(alpha), bits,
                int(symmetric), _stream())
    else:
        in_smem = lib.rpiq_block_yq_in_smem(n, block_size, rows, split)
        _require(in_smem >= 0, op, f"rows={rows}, split={split}, "
                 f"block_size={block_size}: "
                 + ("querying the card's shared memory failed"
                    if in_smem == -1
                    else "a launch geometry the kernel does not take"))
        # a cluster's blocks share their directed residuals through here
        dbuf = torch.empty((b, parts, n, rows) if split > 1 else (0,),
                           dtype=torch.float32, device=dev)
        _launch(op, lib.rpiq_block_launch, *(a.data_ptr() for a in args),
                *outs, hist.data_ptr(), pls.data_ptr(), dbuf.data_ptr(), b,
                out_dim, in_dim, n, block_size, t_max, float(alpha), bits,
                int(symmetric), rows, split, _stream())
    return (w_cont, wp_all, y_q, hist.sum(dim=1).float(),
            pls.sum(dim=1).float())


def _rpiq_select(hist_raw: Tensor, pls_raw: Tensor, wp_all: Tensor,
                 t_max: int, early_stop: bool):
    """Replay the closed loop's bookkeeping over the raw round trajectory.

    Round 1 always runs; round r+1 runs iff round r did not trip the stop
    predicate ``Γ_r >= Γ_{r-1}·(1-1e-6)``; rounds that would not have run
    mask to +inf in the history; the returned candidate is the FIRST round
    reaching the minimum projected loss (strict improvement: slot 0 is the
    stage-1 solution, so "no round improved" selects it).
    """
    b = hist_raw.shape[0]
    dev = hist_raw.device
    if early_stop:
        stop = hist_raw[:, 1:] >= hist_raw[:, :-1] * (1.0 - 1e-6)
    else:
        stop = torch.zeros((b, t_max), dtype=torch.bool, device=dev)
    live = torch.cumprod((~stop).to(torch.int32), dim=1)
    exec_mask = torch.cat([torch.ones((b, 1), dtype=torch.int32, device=dev),
                           live[:, :-1]], dim=1).bool()
    iters = exec_mask.sum(dim=1).to(torch.int32)
    keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                      exec_mask], dim=1)
    inf = torch.tensor(float("inf"), device=dev)
    hist = torch.where(keep, hist_raw, inf)
    cand = torch.where(keep, pls_raw, inf)
    best = _first_argmin(cand)
    proj_loss = cand.gather(1, best[:, None])[:, 0]
    w_q = wp_all[torch.arange(b, device=dev), best]
    return w_q, hist, proj_loss, iters


def _first_argmin(a: Tensor) -> Tensor:
    """Index of the first minimum along dim 1 (ties → lowest index)."""
    cols = torch.arange(a.shape[1], device=a.device).expand_as(a)
    big = torch.full_like(cols, a.shape[1])
    return torch.where(a == a.min(dim=1, keepdim=True).values, cols,
                       big).min(dim=1).values


def rpiq_block(w_init: Tensor, w_fp: Tensor, x_last: Tensor,
               hinv_blocks: Tensor, scales: Tensor, zeros: Tensor, *,
               bits: int = 4, group_size: int = 128, block_size: int = 128,
               alpha: float = 0.01, t_max: int = 5, early_stop: bool = True,
               symmetric: bool = False):
    """The full stage-2 closed loop. w_init/w_fp (out, in) or (B, out, in);
    x_last (B, n, in); hinv_blocks (B, M, bs, bs) explicit block inverses;
    scales/zeros (B, out, in/group_size). Returns ``(w_q, w_cont,
    loss_history, proj_loss, iters_run)``; ``w_cont`` is the t_max-round
    iterate (every round runs, the bookkeeping is replayed)."""
    squeeze = w_init.dim() == 2
    if squeeze:
        w_init, w_fp, x_last, hinv_blocks, scales, zeros = (
            a[None] for a in (w_init, w_fp, x_last, hinv_blocks, scales,
                              zeros))
    b, out_dim, in_dim = w_init.shape
    _require(in_dim % block_size == 0 and block_size % group_size == 0,
             "rpiq_block", f"in={in_dim}, block_size={block_size}, "
             f"group_size={group_size} are not aligned")
    xf = x_last.float()
    # Y_orig = X W_fpᵀ and the column-resolution grid: plain products
    # outside the kernel, as in the JAX dispatcher
    y_orig = xf @ w_fp.float().transpose(1, 2)
    s_full = scales.float().repeat_interleave(group_size, dim=-1)
    z_full = zeros.float().repeat_interleave(group_size, dim=-1)
    w0 = w_init.float()
    hinv_flat = hinv_blocks.float().reshape(b, in_dim, block_size)
    kw = dict(bits=bits, block_size=block_size, alpha=alpha, t_max=t_max,
              symmetric=symmetric)
    if _is_plain(w0, "rpiq_block"):
        w_cont, wp_all, _, hist_raw, pls_raw = ref.rpiq_block(
            w0, y_orig, xf, hinv_flat, s_full, z_full, **kw)
    else:
        w0, y_orig, s_full, z_full = rpiq_pad_rows(w0, y_orig, s_full,
                                                   z_full, RPIQ_ROWS)
        w_cont, wp_all, _, hist_raw, pls_raw = rpiq_block_cuda(
            *(a.contiguous() for a in (w0, y_orig, xf, hinv_flat, s_full,
                                       z_full)), **kw)
        w_cont, wp_all = w_cont[:, :out_dim], wp_all[:, :, :out_dim]
    w_q, hist, proj_loss, iters = _rpiq_select(hist_raw, pls_raw, wp_all,
                                               t_max, early_stop)
    out = (w_q, w_cont, hist, proj_loss, iters)
    if squeeze:
        out = tuple(o[0] for o in out)
    return out


# ---------------------------------------------------------------------------
# one-token GQA decode attention against the int8 KV cache
# ---------------------------------------------------------------------------

# history slots a tile of the int8_kv_attention kernel; its ranges are
# whole tiles
KV_TILE = 128


@functools.lru_cache(maxsize=1024)
def int8_kv_attention_geometry(b: int, kv: int, s: int) -> Tuple[int, int]:
    """The int8_kv_attention launch for B x KV cells over S history slots:
    ``(splits, tiles_per_split)``. Each cell's ceil(S / KV_TILE) tiles are
    cut into ranges of whole tiles, one block each: the fewest tiles a
    range that still keeps to two blocks an SM (shorter ranges, more
    blocks, were slower on the H100: the sweep of chip_compare.py), then
    spread evenly, so no range is empty and S <= KV_TILE takes one."""
    tiles = -(-s // KV_TILE)
    cells = b * kv
    per = max(1, -(-(cells * tiles) // (2 * SMS)))
    splits = -(-tiles // per)
    per = -(-tiles // splits)
    return -(-tiles // per), per


# per device: the ticket counters (zero between calls) and fp32 partials of
# the split int8_kv_attention launches, grown on demand and kept (a
# CapturedCall holds the ones it captured); the calls of one device share
# them, so they must be enqueued on one stream
_KV_WORK: Dict[int, tuple] = {}


def _kv_workspace(q: Tensor, cells: int, floats: int) -> Tuple[int, int]:
    """Pointers to at least ``cells`` zeroed tickets and ``floats``
    partials on q's device."""
    dev = q.get_device()
    ws = _KV_WORK.get(dev)
    if ws is None or ws[0] < cells or ws[1] < floats:
        if ws is not None:
            cells, floats = max(cells, ws[0]), max(floats, ws[1])
        tickets = torch.zeros(cells, dtype=torch.int32, device=q.device)
        work = torch.empty(floats, dtype=torch.float32, device=q.device)
        ws = (cells, floats, tickets.data_ptr(), work.data_ptr(), tickets,
              work)
        _KV_WORK[dev] = ws
    return ws[2], ws[3]


def int8_kv_attention_cuda(q: Tensor, k_codes: Tensor, k_scales: Tensor,
                           v_codes: Tensor, v_scales: Tensor, kpos: Tensor,
                           kv_block: int) -> Tensor:
    """Kernel wrapper: same contract as :func:`ref.int8_kv_attention`. One
    launch a call: the history is split over blocks
    (:func:`int8_kv_attention_geometry`) and combined by the kernel."""
    op = "int8_kv_attention"
    _check_cuda(op, q, k_codes, k_scales, v_codes, v_scales, kpos)
    b, kv, r, hd = q.shape
    kshape = k_codes.shape
    s = kshape[1]
    nb = hd // kv_block if kv_block else 0
    ok_types = (k_codes.dtype == v_codes.dtype == torch.int8
                and k_scales.dtype == v_scales.dtype == torch.float32
                and kpos.dtype == torch.int32)
    ok_shapes = (kshape == v_codes.shape == (b, s, kv, hd)
                 and k_scales.shape == v_scales.shape == (b, s, kv, nb)
                 and kpos.shape == (b, s))
    if not (ok_types and ok_shapes and kv_block and hd % kv_block == 0
            and kv_block % 4 == 0 and 1 <= r <= 8 and hd % 16 == 0
            and hd <= 256 and nb <= 8 and k_codes.data_ptr() % 16 == 0
            and v_codes.data_ptr() % 16 == 0):
        raise ValueError(
            f"{op}: q {tuple(q.shape)}, codes {tuple(k_codes.shape)} / "
            f"{tuple(v_codes.shape)} {k_codes.dtype} / {v_codes.dtype}, "
            f"scales {tuple(k_scales.shape)} / {tuple(v_scales.shape)} "
            f"{k_scales.dtype} / {v_scales.dtype}, kpos "
            f"{tuple(kpos.shape)} {kpos.dtype}, kv_block {kv_block}: the "
            "kernel takes int8 codes (B, S, KV, hd), f32 scales (B, S, KV, "
            "hd/kv_block), int32 kpos (B, S), kv_block a multiple of 4 "
            "dividing hd, R <= 8 query rows per kv-head, hd a multiple of "
            "16 up to 256, at most 8 scale blocks per row, and codes "
            "16-byte aligned (16-byte loads)")
    lib = build.load(op)
    if q.dtype == torch.float32:
        fn = lib.int8_kv_attention_f32_launch
    elif q.dtype == torch.bfloat16:
        fn = lib.int8_kv_attention_bf16_launch
    else:
        raise ValueError(f"{op}: q dtype {q.dtype} not supported")
    splits, per = int8_kv_attention_geometry(b, kv, s)
    tickets = work = 0
    if splits > 1:
        tickets, work = _kv_workspace(q, b * kv,
                                      b * kv * splits * (r * hd + 2 * r))
    out = torch.empty_like(q)
    _launch(op, fn, q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
            v_codes.data_ptr(), v_scales.data_ptr(), kpos.data_ptr(),
            out.data_ptr(), b, s, kv, r, hd, kv_block, splits, per, work,
            tickets, _stream())
    return out


def int8_kv_attention(q: Tensor, k_codes: Tensor, k_scales: Tensor,
                      v_codes: Tensor, v_scales: Tensor, kpos: Tensor, *,
                      kv_block: int) -> Tensor:
    """q (B, KV, R, hd) pre-scaled; k/v codes (B, S, KV, hd) int8; k/v
    scales (B, S, KV, hd // kv_block) f32; kpos (B, S) int32, -1 = an
    invalid slot. Returns (B, KV, R, hd) in q.dtype."""
    args = (q, k_codes, k_scales, v_codes, v_scales, kpos)
    if _is_plain(q, "int8_kv_attention"):
        return ref.int8_kv_attention(*args, kv_block)
    return int8_kv_attention_cuda(*(a.contiguous() for a in args), kv_block)


# ---------------------------------------------------------------------------
# quantize onto a fixed 4-bit grid + pack two codes to a byte
# ---------------------------------------------------------------------------

def quant_pack_cuda(w: Tensor, scales: Tensor, zeros: Tensor,
                    group_size: int) -> Tensor:
    """Kernel wrapper: same contract as :func:`ref.quant_pack`."""
    op = "quant_pack"
    _check_cuda(op, w, scales, zeros)
    n, k = w.shape
    _require(k % 8 == 0 and w.data_ptr() % 16 == 0, op,
             f"k={k} must be a multiple of 8 and w 16-byte aligned "
             "(16-byte loads of 8 columns)")
    _require(n * (k // 8) < 2 ** 31, op, "the kernel indexes n * k / 8 "
             "spans with 32-bit integers")
    _require(group_size >= 1 and k % group_size == 0, op,
             f"group_size {group_size} must divide k={k}")
    _require(scales.dtype == torch.float32 and zeros.dtype == torch.float32,
             op, "scales/zeros must be float32")
    _require(scales.shape == (n, k // group_size) == zeros.shape, op,
             "scales/zeros must be (n, k/group_size)")
    out = torch.empty((n, k // 2), dtype=torch.uint8, device=w.device)
    lib = build.load(op)
    if w.dtype == torch.float32:
        fn = lib.quant_pack_f32_launch
    elif w.dtype == torch.bfloat16:
        fn = lib.quant_pack_bf16_launch
    else:
        raise ValueError(f"{op}: w dtype {w.dtype} not supported")
    _launch(op, fn, w.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            out.data_ptr(), n, k, group_size, _stream())
    return out


def quant_pack(w: Tensor, scales: Tensor, zeros: Tensor, *,
               group_size: int = 128) -> Tensor:
    """w (n, k) f32/bf16 → (n, k // 2) uint8 codes on the (scales, zeros)
    grid, the even column in the low nibble."""
    if _is_plain(w, "quant_pack"):
        return ref.quant_pack(w, scales, zeros, group_size)
    return quant_pack_cuda(w.contiguous(), scales.contiguous(),
                           zeros.contiguous(), group_size)


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------

def selective_scan_cuda(u: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                        a_log: Tensor, d_skip: Tensor, h0: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """Kernel wrapper: same contract as :func:`ref.selective_scan`, with
    every input but u in float32; h_last comes back in float32. Each
    channel's states are split over two lanes (``selective_scan.cu``)."""
    op = "selective_scan"
    args = (u, dt, bm, cm, a_log, d_skip, h0)
    _check_cuda(op, *args)
    _require(all(a.dtype == torch.float32 for a in args[1:]), op,
             "dt, B, C, a_log, d_skip and h0 must be float32")
    b, s, d = u.shape
    n = bm.shape[-1]
    _require(dt.shape == (b, s, d), op, f"dt must be ({b}, {s}, {d})")
    _require(bm.shape == (b, s, n) == cm.shape, op,
             f"B and C must be ({b}, {s}, n)")
    _require(a_log.shape == (d, n) and d_skip.shape == (d,)
             and h0.shape == (b, d, n), op,
             f"a_log must be ({d}, {n}), d_skip ({d},), h0 ({b}, {d}, {n})")
    lib = build.load(op)
    tile = lib.selective_scan_channels_per_block()
    n_max = lib.selective_scan_max_state()
    _require(b >= 1 and s >= 1 and d % tile == 0 and 1 <= n <= n_max, op,
             f"B={b}, S={s}, d={d}, n={n}: the kernel takes B, S >= 1, d "
             f"a multiple of {tile} and n <= {n_max}")
    _require(u.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0, op,
             "u and dt must be 16-byte aligned (16-byte copies)")
    if u.dtype == torch.float32:
        fn = lib.selective_scan_f32_launch
    elif u.dtype == torch.bfloat16:
        fn = lib.selective_scan_bf16_launch
    else:
        raise ValueError(f"{op}: u dtype {u.dtype} not supported")
    y = torch.empty_like(u)
    h_last = torch.empty_like(h0)
    _launch(op, fn, *(a.data_ptr() for a in args), y.data_ptr(),
            h_last.data_ptr(), b, s, d, n, _stream())
    return y, h_last


def selective_scan(u: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                   a_log: Tensor, d_skip: Tensor, h0: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """u/dt (B, S, d); bm/cm (B, S, n); a_log (d, n); d_skip (d,); h0
    (B, d, n). Returns (y (B, S, d) in u's dtype, h_last in h0's dtype).
    B and C arrive as views of the x projection (row stride dt_rank + 2n)
    and are made contiguous here."""
    args = (u, dt, bm, cm, a_log, d_skip, h0)
    if _is_plain(u, "selective_scan"):
        return ref.selective_scan(*args)
    y, h_last = selective_scan_cuda(
        u.contiguous(), *(a.float().contiguous() for a in args[1:]))
    return y, h_last.to(h0.dtype)
