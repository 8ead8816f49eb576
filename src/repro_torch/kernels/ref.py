"""Plain PyTorch versions of the seven kernels of the quantize → serve
path, and of the selective scan's backward (Mamba training).

Each function has the signature of its kernel wrapper in
:mod:`repro_torch.kernels.ops` and computes what the kernel computes, in
the order the JAX reference (``repro.kernels.ref`` / ``repro.core``)
computes it. They serve as the CPU path of the dispatcher, as the CPU
tests' subject, and as what ``chip_smoke.py`` holds each kernel against on
the card (called directly there, never through the dispatcher).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import kv_codec

Tensor = torch.Tensor


def hessian_accum(x: Tensor, H: Tensor) -> Tensor:
    """``H + XᵀX`` with fp32 accumulation. x: (n, d) f32; H: (d, d) f32."""
    xf = x.float()
    return H + xf.T @ xf


def w4a16_matmul(x: Tensor, packed: Tensor, scales: Tensor, zeros: Tensor,
                 group_size: int) -> Tensor:
    """``y = x @ dequant(W)ᵀ``.

    x (m, k) bf16/f32; packed (n, k/2) uint8, low nibble = even column;
    scales/zeros (n, k/group_size) f32. Returns (m, n) in x.dtype with the
    products accumulated in fp32.
    """
    n, kh = packed.shape
    lo = (packed & 0x0F).float()
    hi = (packed >> 4).float()
    codes = torch.stack([lo, hi], dim=-1).reshape(n, 2 * kh)
    s = scales.float().repeat_interleave(group_size, dim=1)
    z = zeros.float().repeat_interleave(group_size, dim=1)
    w = (codes - z) * s
    return (x.float() @ w.T).to(x.dtype)


def _group_qparams(wg: Tensor, bits: int, symmetric: bool):
    """Per-row (scale, zero) of one group slab wg (..., rows, g). The
    divisors are tensors: on CUDA torch divides by a Python scalar through
    its reciprocal, one ulp off the true division that the reference and
    the kernels take (the same on the CPU)."""
    qmax = 2.0 ** bits - 1.0
    if symmetric:
        absmax = wg.abs().amax(dim=-1)
        scale = torch.clamp(
            absmax / torch.full_like(absmax, 2.0 ** (bits - 1) - 1),
            min=1e-8)
        return scale, torch.zeros_like(scale)
    wmax = torch.clamp(wg.amax(dim=-1), min=0.0)
    wmin = torch.clamp(wg.amin(dim=-1), max=0.0)
    scale = torch.clamp((wmax - wmin) / torch.full_like(wmax, qmax),
                        min=1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0.0, qmax)
    return scale, zero


def project(b: Tensor, s: Tensor, z: Tensor, bits: int,
            symmetric: bool) -> Tensor:
    """Q(·): round onto a fixed grid (eq. 7); s/z at column resolution.
    ``torch.round`` rounds halves to even, as ``jnp.round`` does."""
    if symmetric:
        lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
        return torch.clamp(torch.round(b / s), lo, hi) * s
    qmax = 2.0 ** bits - 1.0
    q = torch.clamp(torch.round(b / s) + z, 0.0, qmax)
    return (q - z) * s


def gptq_block(w: Tensor, hinv_u: Tensor, *, bits: int, group_size: int,
               blocksize: int, symmetric: bool
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The GPTQ lazy-block sweep (``repro.core.gptq._gptq_core``), stacked.

    w (B, out, in) f32; hinv_u (B, in, in) upper Cholesky factor of the
    damped inverse Hessian. Returns (w_q, scales, zeros, err_rows) with
    err_rows (B, out) the per-row Σerr².
    """
    b, out_dim, in_dim = w.shape
    w = w.float().clone()
    u = hinv_u.float()
    n_groups = in_dim // group_size
    scales = w.new_zeros(b, out_dim, n_groups)
    zeros = w.new_zeros(b, out_dim, n_groups)
    err_rows = w.new_zeros(b, out_dim)
    for c1 in range(0, in_dim, blocksize):
        c2 = c1 + blocksize
        wb = w[:, :, c1:c2].clone()
        ub = u[:, c1:c2, c1:c2]
        errb = torch.zeros_like(wb)
        scale = zero = None
        for j in range(blocksize):
            if j % group_size == 0:
                scale, zero = _group_qparams(wb[:, :, j:j + group_size],
                                             bits, symmetric)
                g = (c1 + j) // group_size
                scales[:, :, g] = scale
                zeros[:, :, g] = zero
            wcol = wb[:, :, j]
            q = project(wcol, scale, zero, bits, symmetric)
            err = (wcol - q) / ub[:, j, j][:, None]
            wb[:, :, j + 1:] -= err[:, :, None] * ub[:, None, j, j + 1:]
            wb[:, :, j] = q
            errb[:, :, j] = err
        w[:, :, c2:] -= errb @ u[:, c1:c2, c2:]
        w[:, :, c1:c2] = wb
        err_rows += (errb * errb).sum(dim=-1)
    return w, scales, zeros, err_rows


def rpiq_block(w0: Tensor, y_orig: Tensor, x: Tensor, hinv_flat: Tensor,
               s_full: Tensor, z_full: Tensor, *, bits: int, block_size: int,
               alpha: float, t_max: int, symmetric: bool
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Every Gauss–Seidel round of RPIQ stage 2, run unconditionally.

    w0 (B, out, in) stage-1 weights; y_orig (B, n, out) = X W_fpᵀ; x (B, n,
    in); hinv_flat (B, in, bs) the stacked block inverses H_i⁻¹; s_full /
    z_full (B, out, in) the stage-1 grid at column resolution.

    Returns ``(w_cont, wp_all, y_q, hist_raw, pls_raw)``: the t_max-round
    iterate, the per-round projected candidates (B, t_max+1, out, in) with
    slot 0 = W₀, the final running outputs, and the raw per-round Γ and
    projected-loss sums (B, t_max+1). The early stop and the best choice
    are replayed afterwards (``ops._rpiq_select``).
    """
    bsz, out_dim, in_dim = w0.shape
    n_blocks = in_dim // block_size
    x = x.float()
    w = w0.float().clone()
    y_q = x @ w.transpose(1, 2)
    hist = w.new_zeros(bsz, t_max + 1)
    pls = w.new_zeros(bsz, t_max + 1)
    wp_all = w.new_zeros(bsz, t_max + 1, out_dim, in_dim)
    wp_all[:, 0] = w
    g0 = ((y_orig - y_q) ** 2).sum(dim=(1, 2))
    hist[:, 0] = g0
    pls[:, 0] = g0
    for t in range(1, t_max + 1):
        for i in range(n_blocks):
            c1, c2 = i * block_size, (i + 1) * block_size
            b_old = w[:, :, c1:c2]
            x_i = x[:, :, c1:c2]
            y_qi = x_i @ b_old.transpose(1, 2)
            d_i = y_orig - (y_q - y_qi)
            rhs = x_i.transpose(1, 2) @ d_i                  # (B, bs, out)
            b_star = (hinv_flat[:, c1:c2, :] @ rhs).transpose(1, 2)
            b_proj = project(b_star, s_full[:, :, c1:c2],
                             z_full[:, :, c1:c2], bits, symmetric)
            b_new = b_old + alpha * (b_proj - b_old)
            y_q = y_q - y_qi + x_i @ b_new.transpose(1, 2)
            w[:, :, c1:c2] = b_new
        hist[:, t] = ((y_orig - y_q) ** 2).sum(dim=(1, 2))
        w_proj = project(w, s_full, z_full, bits, symmetric)
        wp_all[:, t] = w_proj
        pls[:, t] = ((y_orig - x @ w_proj.transpose(1, 2)) ** 2
                     ).sum(dim=(1, 2))
    return w, wp_all, y_q, hist, pls


def int8_kv_attention(q: Tensor, k_codes: Tensor, k_scales: Tensor,
                      v_codes: Tensor, v_scales: Tensor, kpos: Tensor,
                      kv_block: int, softcap: float = 0.0) -> Tensor:
    """One-token GQA decode against an int8 KV cache, full dequant.

    q (B, KV, R, hd) pre-scaled (hd^-0.5 folded in by the caller); k/v
    codes (B, S, KV, hd) int8; k/v scales (B, S, KV, hd // kv_block) f32;
    kpos (B, S) int32, a negative entry marks an invalid slot; ``softcap``
    > 0 caps the scores as ``tanh(s / softcap) * softcap`` before the
    mask. Returns (B, KV, R, hd) in q.dtype with fp32 scores, softmax and
    values. Invalid slots get weight 0, so a lane with no valid slot
    returns 0, as the fused kernel does (the JAX oracle's plain softmax
    would spread such a lane uniformly).
    """
    k = kv_codec.dec_int8_blocks(k_codes, k_scales, kv_block)
    v = kv_codec.dec_int8_blocks(v_codes, v_scales, kv_block)
    s = torch.einsum("bgrd,bsgd->bgrs", q.float(), k)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = (kpos >= 0)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1) * valid
    return torch.einsum("bgrs,bsgd->bgrd", p, v).to(q.dtype)


def quant_pack(w: Tensor, scales: Tensor, zeros: Tensor,
               group_size: int) -> Tensor:
    """4-bit codes on a fixed asymmetric grid, two to a byte.

    w (n, k) f32/bf16; scales/zeros (n, k / group_size) f32. Codes are
    ``clip(round(w / s) + z, 0, 15)`` (half-to-even, true division);
    returns (n, k / 2) uint8 with the even column in the low nibble.
    """
    s = scales.float().repeat_interleave(group_size, dim=1)
    z = zeros.float().repeat_interleave(group_size, dim=1)
    q = torch.clamp(torch.round(w.float() / s) + z, 0.0, 15.0)
    q = q.to(torch.uint8)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).contiguous()


def selective_scan(u: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                   a_log: Tensor, d_skip: Tensor, h0: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """Mamba-1 diagonal SSM, a sequential loop over time in fp32.

    u/dt (B, S, d); bm/cm (B, S, n); a_log (d, n) with A = -exp(a_log);
    d_skip (d,); h0 (B, d, n). Per step ``a_t = exp(dt_t ⊙ A)``, ``h ←
    a_t ⊙ h + (dt_t·u_t) B_t``, ``y_t = Σ_n h·C_t + d_skip ⊙ u_t``, as
    ``repro.kernels.ref.selective_scan_ref``. Returns (y (B, S, d) in u's
    dtype, h_last (B, d, n) in h0's dtype).
    """
    A = -torch.exp(a_log.float())
    uf, dtf, bf, cf = u.float(), dt.float(), bm.float(), cm.float()
    dsk = d_skip.float()
    h = h0.float()
    y = torch.empty(uf.shape, dtype=torch.float32, device=u.device)
    for t in range(u.shape[1]):
        dt_t, u_t = dtf[:, t], uf[:, t]
        a_t = torch.exp(dt_t[..., None] * A[None])
        h = a_t * h + (dt_t * u_t)[..., None] * bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t]) + u_t * dsk
    return y.to(u.dtype), h.to(h0.dtype)


def selective_scan_backward(u: Tensor, dt: Tensor, bm: Tensor, cm: Tensor,
                            a_log: Tensor, d_skip: Tensor, h0: Tensor,
                            dy: Tensor, dh_last: Optional[Tensor] = None
                            ) -> Tuple[Tensor, ...]:
    """The VJP of :func:`selective_scan` for the cotangents dy (B, S, d) of
    y and dh_last (B, d, n) of h_last (None: zeros), in fp32.

    The states are recomputed forward from h0 and kept, then a reverse
    loop carries ``g_t = ∂L/∂h_t = dy_t ⊗ C_t + a_{t+1} ⊙ g_{t+1}``
    (seeded by dh_last) and forms ``du = dt Σ_n g·B + d_skip·dy``,
    ``ddt = Σ_n g·(A·a_t·h_{t-1} + u·B)``, ``dB = Σ_d g·dt·u``, ``dC =
    Σ_d dy·h_t``, ``dA_log = A·Σ_{b,t} g·a_t·h_{t-1}·dt``, ``dD = Σ_{b,t}
    dy·u`` and ``dh0 = a_0 ⊙ g_0``. Returns (du in u's dtype, ddt, dB, dC,
    dA_log, dD, dh0) in fp32.
    """
    A = -torch.exp(a_log.float())
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, bm, cm, dy))
    dsk = d_skip.float()
    hs = [h0.float()]
    for t in range(u.shape[1]):
        a_t = torch.exp(dtf[:, t, :, None] * A[None])
        hs.append(a_t * hs[-1] + (dtf[:, t] * uf[:, t])[..., None]
                  * bf[:, t, None, :])
    g = (torch.zeros_like(hs[0]) if dh_last is None
         else dh_last.float().clone())
    du, ddt = torch.empty_like(uf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(bf), torch.empty_like(cf)
    dA = torch.zeros_like(A)
    for t in reversed(range(u.shape[1])):
        dt_t, u_t, dy_t = dtf[:, t], uf[:, t], dyf[:, t]
        b_t = bf[:, t, None, :]
        a_t = torch.exp(dt_t[..., None] * A[None])
        g = g + dy_t[..., None] * cf[:, t, None, :]          # ∂L/∂h_t
        ah = a_t * hs[t]                                     # a_t h_{t-1}
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy_t)
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * u_t)
        du[:, t] = dt_t * (g * b_t).sum(-1) + dsk * dy_t
        ddt[:, t] = (g * (A[None] * ah + u_t[..., None] * b_t)).sum(-1)
        dA += (g * ah * dt_t[..., None]).sum(0)
        g = a_t * g
    dD = (dyf * uf).sum(dim=(0, 1))
    return du.to(u.dtype), ddt, dB, dC, dA * A, dD, g
