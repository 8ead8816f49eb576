"""The work of each of the eight kernels: the FLOP it does and the bytes it
must move (each input read once, each output written once), as functions
of its shapes, and the least time the card could take for it.

One function a kernel, whatever implements it: ``chip_smoke.py``'s kernel
table (PERF.md's Bound column), the shape-only dry run
(``launch/dryrun.py``, which reads them from the fake calls of
``kernels/ops.py``) and any later roofline count the same work. The
rates are those of one NVIDIA H100 80GB HBM3 at its 700 W power limit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

# NVIDIA H100 80GB HBM3 (SXM), power limit 700 W: dense rates of the card
H100_FP32_FLOPS = 67e12      # FP32 on the CUDA cores (no tensor cores)
H100_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
H100_BYTES = 3.35e12         # HBM3 bytes per second
H100_NVLINK = 450e9          # NVLink bytes per second, each way


class Work(NamedTuple):
    flop: float
    nbytes: float
    peak: float = H100_FP32_FLOPS     # the FLOP rate that bounds it

    def bound_ms(self) -> float:
        """The least time for the work: its FLOP at ``peak`` or its bytes
        at the HBM rate, whichever is longer."""
        return max(self.flop / self.peak, self.nbytes / H100_BYTES) * 1e3

    def bound_by(self) -> str:
        return ("operations" if self.flop / self.peak
                >= self.nbytes / H100_BYTES else "bytes")


def hessian_accum(n: int, d: int) -> Work:
    """H (d, d) += xᵀx for x (n, d), fp32: the upper triangle's products,
    H read and written."""
    return Work(n * d * (d + 1), (n * d + 2 * d * d) * 4)


def gptq_block(b: int, out_dim: int, in_dim: int, group_size: int,
               blocksize: int) -> Work:
    """One GPTQ sweep of b (out, in) fp32 members: in-block propagation
    (column j of a block updates bs-j-1 columns, a product and a
    difference each) and a rank-bs tail product a block."""
    flop = b * out_dim * in_dim * (blocksize - 1) + sum(
        2 * b * out_dim * blocksize * (in_dim - c2)
        for c2 in range(blocksize, in_dim + 1, blocksize))
    nbytes = 4 * (2 * b * out_dim * in_dim + b * in_dim * in_dim
                  + 2 * b * out_dim * (in_dim // group_size) + b * out_dim)
    return Work(flop, nbytes)


def rpiq_block(b: int, out_dim: int, in_dim: int, n: int, block_size: int,
               t_max: int) -> Work:
    """The closed loop's t_max rounds over b members: the round products,
    the block solves and the projections, every candidate written."""
    flop = b * (2 * n * in_dim * out_dim * (1 + t_max)
                + t_max * (6 * n * in_dim * out_dim
                           + 2 * block_size * in_dim * out_dim))
    nbytes = 4 * b * (3 * out_dim * in_dim + n * out_dim + n * in_dim
                      + (in_dim // block_size) * block_size * block_size
                      + out_dim * in_dim * (t_max + 2) + n * out_dim)
    return Work(flop, nbytes)


def w4a16_matmul(m: int, n: int, k: int, group_size: int,
                 x_bytes: int = 2) -> Work:
    """x (m, k) @ dequant(W (n, k) int4)ᵀ; bf16 x (``x_bytes`` 2) is
    bounded by the bf16 tensor-core rate, fp32 x by the CUDA cores'."""
    nbytes = (n * k / 2 + 2 * n * (k / group_size) * 4 + m * k * x_bytes
              + m * n * x_bytes)
    peak = H100_BF16_FLOPS if x_bytes == 2 else H100_FP32_FLOPS
    return Work(2 * m * n * k, nbytes, peak)


def int8_kv_attention(b: int, kv: int, r: int, hd: int, s: int,
                      scale_blocks: int, valid: Optional[int] = None,
                      q_bytes: int = 2) -> Work:
    """One-token GQA attention of b x kv cells of r query rows over s
    int8 slots: the codes and scales of the ``valid`` slots (all b·s
    unless the caller counts what its data needs), every position, q in
    and out."""
    valid = b * s if valid is None else valid
    nbytes = (2 * valid * kv * hd + 2 * valid * kv * scale_blocks * 4
              + 4 * b * s + 2 * q_bytes * b * kv * r * hd)
    return Work(4 * kv * r * valid * hd, nbytes)


def quant_pack(n: int, k: int, group_size: int, w_bytes: int = 4) -> Work:
    """w (n, k) onto its grid, two codes a byte."""
    return Work(4 * n * k, w_bytes * n * k + 8 * n * k / group_size
                + n * k / 2)


def selective_scan(b: int, s: int, d: int, n: int, u_bytes: int = 2
                   ) -> Work:
    """The Mamba-1 scan over b x s x d channels of n states: u and y in
    u's dtype, dt / B / C / a_log / d_skip / h0 / h_last in fp32."""
    nbytes = (b * s * d * (2 * u_bytes + 4) + 2 * b * s * n * 4
              + d * n * 4 + d * 4 + 2 * b * d * n * 4)
    return Work(7 * b * s * d * n, nbytes)


def selective_scan_backward(b: int, s: int, d: int, n: int,
                            u_bytes: int = 2, dh_last: bool = True) -> Work:
    """The scan's VJP over b x s x d channels of n states, each product
    counted once: the states recomputed (dt·A, its exp a_t, a_t·h_{t-1},
    dt·u·B and their sum: 5 a state) and the reverse pass (g from dy·C and
    the carry a_t·g; g·B, g·(A·a_t·h_{t-1} + u·B), g·a_t·h_{t-1}·dt, g·dt·u
    and dy·h with their sums over n, d or time: 17 a state, a_t and
    a_t·h_{t-1} taken from the recompute). Bytes: u and dy (u's dtype), dt, B, C,
    a_log, d_skip, h0 and dh_last (when given) read once; du (u's dtype),
    ddt, dB, dC, dA_log, dD and dh0 written once. The kernel's scratch
    (:func:`selective_scan_backward_scratch`) is not work the function
    must do, so the bound leaves it out."""
    nbytes = (b * s * d * (2 * u_bytes + 4) + 2 * b * s * n * 4
              + d * n * 4 + d * 4 + (1 + dh_last) * b * d * n * 4
              + b * s * d * (u_bytes + 4) + 2 * b * s * n * 4
              + d * n * 4 + d * 4 + b * d * n * 4)
    return Work(22 * b * s * d * n, nbytes)


def selective_scan_backward_scratch(b: int, s: int, d: int) -> int:
    """Bytes of scratch ``selective_scan_bwd.cu`` takes: every state but
    the last (b, max(s-1, 1), d, 16) fp32, the per-block partials of dB and
    dC (b, d/64, s, 32), and per-batch-row partials of dA_log (b, d, 16)
    and dD (b, d). Each is written once and read once."""
    return 4 * (b * max(s - 1, 1) * d * 16 + b * (d // 64) * s * 32
                + b * d * 16 + b * d)
