"""Dispatch layer for the port's seven kernels.

Each op takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
for a tensor on the CPU and launches its hand-written CUDA kernel for a
tensor on a CUDA device. There is no fallback on the card: a shape, dtype
or layout the kernel does not take, a failed build or a launch error
raises. Host-side padding (row tiles) and the closed-loop bookkeeping of
RPIQ stage 2 live here, as in the JAX package's ``repro.kernels.ops``.

Every ``*_cuda`` wrapper adds one to its launch counter where it launches
its kernel; :func:`kernel_launches` reads the counters, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

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


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _require(cond: bool, op: str, why: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {why}")


def _check_cuda(op: str, *tensors: Tensor) -> None:
    for t in tensors:
        _require(t.is_cuda, op, f"expected CUDA tensors, got {t.device}")
        _require(t.is_contiguous(), op, "expected contiguous tensors")


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
            _stream())
    return H


def hessian_accum(x: Tensor, H: Tensor) -> Tensor:
    """``H + XᵀX`` for x (n, d) f32; on CUDA, H is updated in place."""
    if _is_plain(x, "hessian_accum"):
        return ref.hessian_accum(x, H)
    return hessian_accum_cuda(x.contiguous(), H)


# ---------------------------------------------------------------------------
# y = x @ dequant(W)^T      (W packed int4, grouped scales/zeros)
# ---------------------------------------------------------------------------

def w4a16_matmul_cuda(x: Tensor, packed: Tensor, scales: Tensor,
                      zeros: Tensor, group_size: int) -> Tensor:
    """Kernel wrapper: x (m, k) f32/bf16 → (m, n) in x.dtype."""
    op = "w4a16_matmul"
    _check_cuda(op, x, packed, scales, zeros)
    m, k = x.shape
    n, kh = packed.shape
    _require(packed.dtype == torch.uint8, op, "packed must be uint8")
    _require(scales.dtype == torch.float32 and zeros.dtype == torch.float32,
             op, "scales/zeros must be float32")
    _require(kh * 2 == k, op, f"x has k={k}, packed has {2 * kh} columns")
    _require(k % 32 == 0 and packed.data_ptr() % 16 == 0, op,
             f"k={k} must be a multiple of 32 and packed 16-byte aligned "
             "(16-byte packed loads)")
    _require(group_size % 2 == 0 and k % group_size == 0, op,
             f"group_size {group_size} must be even and divide k={k}")
    _require(scales.shape == (n, k // group_size) == zeros.shape, op,
             "scales/zeros must be (n, k/group_size)")
    _require(k <= 8192, op, f"k={k}: the x tile must fit shared memory")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.load(op)
    if x.dtype == torch.float32:
        fn = lib.w4a16_matmul_f32_launch
    elif x.dtype == torch.bfloat16:
        fn = lib.w4a16_matmul_bf16_launch
    else:
        raise ValueError(f"{op}: x dtype {x.dtype} not supported")
    _launch(op, fn, x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), y.data_ptr(), m, n, k, group_size, _stream())
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
    """Kernel wrapper: same contract as :func:`ref.gptq_block`; the row
    count must be a multiple of the kernel's row tile."""
    op = "gptq_block"
    _check_cuda(op, w, hinv_u)
    _require(w.dtype == torch.float32 and hinv_u.dtype == torch.float32, op,
             "w and hinv_u must be float32")
    b, out_dim, in_dim = w.shape
    lib = build.load(op)
    rows = lib.gptq_block_rows_per_block()
    _require(out_dim % rows == 0, op, f"out={out_dim} must be a multiple "
             f"of {rows} (ops.gptq_block pads)")
    smem = 4 * (blocksize * blocksize + 2 * rows * blocksize)
    _require(smem <= 227 * 1024, op, f"blocksize {blocksize} needs {smem} B "
             "of shared memory (> 227 KB)")
    _require(group_size <= blocksize, op, "group_size must be <= blocksize")
    w_q = w.clone()
    scales = torch.empty((b, out_dim, in_dim // group_size),
                         dtype=torch.float32, device=w.device)
    zeros = torch.empty_like(scales)
    err_rows = torch.zeros((b, out_dim), dtype=torch.float32,
                           device=w.device)
    _launch(op, lib.gptq_block_launch, w_q.data_ptr(), hinv_u.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), err_rows.data_ptr(), b,
            out_dim, in_dim, bits, group_size, blocksize, int(symmetric),
            _stream())
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
    out_dim, in_dim = w.shape[-2:]
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
        rows = build.load("gptq_block").gptq_block_rows_per_block()
        out_pad = _round_up(out_dim, rows)
        wp = torch.nn.functional.pad(w, (0, 0, 0, out_pad - out_dim))
        w_q, scales, zeros, err_rows = gptq_block_cuda(
            wp.contiguous(), hinv_u.contiguous(), **kw)
        w_q, scales, zeros = (w_q[:, :out_dim], scales[:, :out_dim],
                              zeros[:, :out_dim])
        err_rows = err_rows[:, :out_dim]
    out = (w_q, scales, zeros, err_rows.sum(dim=-1))
    if squeeze:
        out = tuple(o[0] for o in out)
    return out


# ---------------------------------------------------------------------------
# RPIQ closed-loop refinement (stage 2)
# ---------------------------------------------------------------------------

def rpiq_block_cuda(w0: Tensor, y_orig: Tensor, x: Tensor, hinv_flat: Tensor,
                    s_full: Tensor, z_full: Tensor, *, bits: int,
                    block_size: int, alpha: float, t_max: int,
                    symmetric: bool
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Kernel wrapper: same contract as :func:`ref.rpiq_block`; the row
    count must be a multiple of the kernel's row tile. The per-row-tile
    partials are summed here, in tile order."""
    op = "rpiq_block"
    args = (w0, y_orig, x, hinv_flat, s_full, z_full)
    _check_cuda(op, *args)
    _require(all(a.dtype == torch.float32 for a in args), op,
             "all inputs must be float32")
    b, out_dim, in_dim = w0.shape
    n = x.shape[1]
    lib = build.load(op)
    rows = lib.rpiq_block_rows_per_block()
    _require(out_dim % rows == 0, op, f"out={out_dim} must be a multiple "
             f"of {rows} (ops.rpiq_block pads)")
    _require(t_max >= 0, op, "t_max must be >= 0")
    tiles = out_dim // rows
    dev = w0.device
    w_cont = torch.empty_like(w0)
    wp_all = torch.empty((b, t_max + 1, out_dim, in_dim), dtype=torch.float32,
                         device=dev)
    y_q = torch.empty((b, n, out_dim), dtype=torch.float32, device=dev)
    hist = torch.empty((b, tiles, t_max + 1), dtype=torch.float32,
                       device=dev)
    pls = torch.empty_like(hist)
    per_block = lib.rpiq_block_scratch_floats(n, block_size)
    _require(per_block >= 0, op, "querying the card's shared memory failed")
    # empty when the block's working set fits shared memory
    scratch = torch.empty((b, tiles, per_block), dtype=torch.float32,
                          device=dev)
    _launch(op, lib.rpiq_block_launch, *(a.data_ptr() for a in args),
            w_cont.data_ptr(), wp_all.data_ptr(), y_q.data_ptr(),
            hist.data_ptr(), pls.data_ptr(), scratch.data_ptr(), b, out_dim,
            in_dim, n, block_size, t_max, float(alpha), bits, int(symmetric),
            _stream())
    return w_cont, wp_all, y_q, hist.sum(dim=1), pls.sum(dim=1)


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
        rows = build.load("rpiq_block").rpiq_block_rows_per_block()
        pad = _round_up(out_dim, rows) - out_dim
        if pad:
            # padded rows: w = 0 on an (s = 1, z = 0) grid project to 0 and
            # add nothing to the residuals or the loss partials
            w0 = torch.nn.functional.pad(w0, (0, 0, 0, pad))
            s_full = torch.nn.functional.pad(s_full, (0, 0, 0, pad),
                                             value=1.0)
            z_full = torch.nn.functional.pad(z_full, (0, 0, 0, pad))
            y_orig = torch.nn.functional.pad(y_orig, (0, pad))
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

def int8_kv_attention_cuda(q: Tensor, k_codes: Tensor, k_scales: Tensor,
                           v_codes: Tensor, v_scales: Tensor, kpos: Tensor,
                           kv_block: int) -> Tensor:
    """Kernel wrapper: same contract as :func:`ref.int8_kv_attention`."""
    op = "int8_kv_attention"
    _check_cuda(op, q, k_codes, k_scales, v_codes, v_scales, kpos)
    b, kv, r, hd = q.shape
    s = k_codes.shape[1]
    _require(hd % kv_block == 0 and kv_block % 4 == 0, op,
             f"kv_block {kv_block} must be a multiple of 4 dividing "
             f"hd={hd}")
    nb = hd // kv_block
    _require(k_codes.dtype == torch.int8 and v_codes.dtype == torch.int8,
             op, "codes must be int8")
    _require(k_scales.dtype == torch.float32 and
             v_scales.dtype == torch.float32, op, "scales must be float32")
    _require(kpos.dtype == torch.int32, op, "kpos must be int32")
    _require(k_codes.shape == (b, s, kv, hd) == v_codes.shape, op,
             f"codes must be (B, S, KV, hd) = ({b}, S, {kv}, {hd})")
    _require(k_scales.shape == (b, s, kv, nb) == v_scales.shape, op,
             f"scales must be (B, S, KV, hd/kv_block) = ({b}, {s}, {kv}, "
             f"{nb})")
    _require(kpos.shape == (b, s), op, f"kpos must be ({b}, {s})")
    _require(1 <= r <= 8 and hd % 16 == 0 and hd <= 256 and nb <= 8, op,
             f"R={r}, hd={hd}, kv_block={kv_block}: the kernel takes R <= 8 "
             "query rows per kv-head, hd a multiple of 16 up to 256 and at "
             "most 8 scale blocks per row")
    _require(k_codes.data_ptr() % 16 == 0 and v_codes.data_ptr() % 16 == 0,
             op, "codes must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(q)
    lib = build.load(op)
    if q.dtype == torch.float32:
        fn = lib.int8_kv_attention_f32_launch
    elif q.dtype == torch.bfloat16:
        fn = lib.int8_kv_attention_bf16_launch
    else:
        raise ValueError(f"{op}: q dtype {q.dtype} not supported")
    _launch(op, fn, q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
            v_codes.data_ptr(), v_scales.data_ptr(), kpos.data_ptr(),
            out.data_ptr(), b, s, kv, r, hd, kv_block, _stream())
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
    every input but u in float32; h_last comes back in float32."""
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
