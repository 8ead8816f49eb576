#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: name, count, and ``nvidia-smi`` name / power limit;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
     nvcc (in parallel), printing each kernel's ptxas registers, shared
     memory and spills;
  3. kernels: each of the seven kernels' wrappers against its plain
     PyTorch version on the card, at the shapes the main paths give it
     (opt-proxy, internlm2-1.8b and falcon-mamba-7b), with the error
     against the stated tolerance and CUDA-event times (kernel, plain,
     library yardstick where one exists, itself held against the plain
     version) beside the least time the card could take (bf16
     ``w4a16_matmul`` at the bf16 tensor-core rate, the rest at fp32 on the
     CUDA cores); two launches of ``hessian_accum`` and
     ``int8_kv_attention``, and of ``w4a16_matmul`` where it splits k over
     blocks, on the same inputs must agree bitwise; ``w4a16_matmul`` also
     at groups 8 and 16 in bf16 and at k 12288 in fp32,
     ``int8_kv_attention`` at one history range and with ranges of -1
     slots only, ``rpiq_block`` on 8 seeded instances of its two narrowest
     groups, ``gptq_block`` and ``rpiq_block`` at blocksizes 256 and in
     (the wide paths), and ``quant_pack`` in fp32 and bf16;
  4. small end to end: opt-proxy smoke (bf16 cache), internlm2 smoke (int8
     KV cache) and falcon-mamba smoke (recurrent state) quantized, packed
     and served on the card against the same runs of the plain versions on
     the CPU in fp32; then each at its own bf16 and group size (16, 8, 8)
     on the card, its first layer's kernel calls held at one bf16 ulp;
  5. main path at full width: opt-proxy (OPT-125M shape) from seeded random
     weights → quantize_model → pack_for_serving → generate, with launch
     counters reset just before and read just after, the packed-vs-float
     logits check, and the decoded tokens; then generate's decode, a
     replayed CUDA graph of one step, against the same loop stepped
     eagerly: equal tokens and launch counts, 8 replayed steps' logits
     bitwise the eager steps', the decode step walls eager and replayed,
     the capture wall and a profiled replay's idle share (so also after
     phases 6 and 7);
  6. the int8-KV main path at full width and depth: internlm2-1.8b (GQA,
     16 heads over 8 KV heads) → quantize_model → pack_for_serving →
     generate with ``serve.kv_cache=int8`` (4 requests x 512 prompt + 32
     new tokens), counters reset and read around it; the packed-vs-float
     logits (in fp32 compute), the int8-vs-bf16 cache drift rule, and
     ``quant_pack`` (kernel and plain version) bitwise against every
     packed linear;
  7. the Mamba-1 main path at full width and depth: falcon-mamba-7b (64
     layers, d_model 4096, d_inner 8192, d_state 16) → quantize_model →
     pack_for_serving → generate (4 requests x 512 prompt + 32 new
     tokens), counters reset and read around it (``selective_scan`` at
     prefill, capture and propagate); the packed-vs-float logits and the
     prefill → decode state hand-off, both in fp32 compute.

The line before the last is a JSON object with one entry per kernel
(``launches`` sums phases 5, 6 and 7); the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_FP32_FLOPS = 67e12      # FP32 on the CUDA cores (no tensor cores)
H100_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
H100_BYTES = 3.35e12         # HBM3 bytes per second
KERNEL_SOURCES = {
    "hessian_accum": ("src/repro_torch/kernels/csrc/hessian_accum.cu",
                      "src/repro/kernels/hessian_accum.py:41"),
    "gptq_block": ("src/repro_torch/kernels/csrc/gptq_block.cu",
                   "src/repro/kernels/gptq_block.py:168"),
    "rpiq_block": ("src/repro_torch/kernels/csrc/rpiq_block.cu",
                   "src/repro/kernels/rpiq_block.py:168"),
    "w4a16_matmul": ("src/repro_torch/kernels/csrc/w4a16_matmul.cu",
                     "src/repro/kernels/w4a16_matmul.py:69"),
    "int8_kv_attention": ("src/repro_torch/kernels/csrc/int8_kv_attention.cu",
                          "src/repro/kernels/kv_attention.py:86"),
    "quant_pack": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                   "src/repro/kernels/quant_pack.py:40"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:71"),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def time_ms(fn, min_total_s: float = 0.2, max_reps: int = 50) -> float:
    """Mean CUDA-event time of fn() after one warm-up call (for calls long
    enough that the host's launch cost hides behind the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    reps = int(max(1, min(max_reps, min_total_s * 1e3 / max(once, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(calls, min_total_s: float = 0.1, max_reps: int = 200) -> float:
    """Device time per call of a CUDA graph that makes ``calls`` in turn.

    A graph replays the captured launches without the host's per-call
    cost, so short kernels are timed as the device runs them. Calls that
    read distinct copies of their operands beyond the 50 MB L2 cache find
    them in device memory, as a decode step's many linears do."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    reps = int(max(1, min(max_reps, min_total_s * 1e3 / max(once, 1e-3))))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def bound(flop: float, nbytes: float, peak: float = H100_FP32_FLOPS):
    """The least time for the work: FLOP at ``peak`` (fp32 on the CUDA
    cores unless the call site names the bf16 tensor-core rate) or bytes
    at the HBM rate, whichever is longer; and which of the two."""
    ops_ms = flop / peak * 1e3
    bytes_ms = nbytes / H100_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


class KernelTable:
    """Per-kernel sums over the checked shapes (one launch of each)."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": None, "max_abs_err": 0.0,
                         "ops_ms": 0.0, "bytes_ms": 0.0}
                     for k in KERNEL_SOURCES}

    def add(self, name, *, ms, plain_ms, flop, nbytes, err, library_ms=None,
            peak=H100_FP32_FLOPS):
        r = self.rows[name]
        b_ms, by = bound(flop, nbytes, peak)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["ops_ms" if by == "operations" else "bytes_ms"] += b_ms
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        return b_ms, by

    def json(self, launches):
        out = []
        for name, r in self.rows.items():
            src, rep = KERNEL_SOURCES[name]
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("operations" if r["ops_ms"] >= r["bytes_ms"]
                             else "bytes"),
                "library_ms": r["library_ms"]})
        return {"kernels": out}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def bf16_ulps(diff, want) -> float:
    """The largest |got - want| in bf16 ulps of each output, the ulp taken
    at no less than 1e-3 of the largest output: below that, cancellation
    leaves values whose fp32 sums' own rounding (~1e-6 of the largest)
    exceeds their bf16 ulp."""
    import torch
    wf = want.float().abs().clamp_min(1e-3 * float(want.float().abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(wf)) - 7)
    return float((diff.float().abs() / ulp).max())


def within_bf16_ulp(diff, want) -> bool:
    """|got - want| within one bf16 ulp of each output (``bf16_ulps``)."""
    return bf16_ulps(diff, want) <= 1.0


def resolve(tree, path: str):
    for k in path.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def frac_differing(a, b, tol_abs: float = 0.0, tol_rel: float = 0.0):
    d = (a - b).abs()
    return float((d > tol_abs + tol_rel * b.abs()).float().mean())


def phase_kernels(table: KernelTable) -> None:
    import torch
    from repro_torch.core.quant import compute_qparams, pack_int4, \
        quantize_codes
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n_tok, gs, bs, t_max, alpha = 512, 128, 128, 5, 0.01

    # -- hessian_accum: H += X^T X (opt-proxy d, internlm2 d, falcon-mamba
    # d: 256 for dt, 4096 for in, 8192 for x and out) -----------------------
    for d in (768, 3072, 2048, 8192, 256, 4096):
        x = torch.randn((n_tok, d), generator=g, device=dev)
        H0 = torch.randn((d, d), generator=g, device=dev)
        H0 = H0 + H0.T
        want = ref.hessian_accum(x, H0)
        got = ops.hessian_accum_cuda(x, H0.clone())
        # no atomics: a second launch on the same inputs, bitwise the same
        same = torch.equal(got, ops.hessian_accum_cuda(x, H0.clone()))
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        Hk = H0.clone()
        ms = graph_ms([lambda: ops.hessian_accum_cuda(x, Hk)])
        pms = graph_ms([lambda: ref.hessian_accum(x, H0)])
        lms = graph_ms([lambda: x.T @ x])
        # the symmetric product needs d(d+1)/2 sums of n products; H is
        # read and written
        b_ms, by = table.add("hessian_accum", ms=ms, plain_ms=pms,
                             flop=n_tok * d * (d + 1),
                             nbytes=(n_tok * d + 2 * d * d) * 4, err=err,
                             library_ms=lms)
        log(f"  hessian_accum n={n_tok} d={d} split "
            f"{ops.hessian_accum_geometry(n_tok, d)}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}); two launches bitwise equal {same}; "
            f"ms={ms:.4f} plain_ms={pms:.4f} library_ms(x.T@x)={lms:.4f} "
            f"bound_ms={b_ms:.4f} ({by})")
        check(err <= tol and same, f"hessian_accum d={d}")

    # -- w4a16_matmul: y = x @ dequant(W)^T ----------------------------------
    # opt-proxy (k, n) at decode m 4 and m 64; internlm2's q/o, k/v,
    # gate/up and down, then falcon-mamba's in, x, dt and out, at decode
    # m 4 and prefill m 4 x 512
    cases = [(m, k, n) for m in (4, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases += [(m, k, n) for m in (4, 2048)
              for k, n in ((2048, 2048), (2048, 1024), (2048, 8192),
                           (8192, 2048), (4096, 16384), (8192, 288),
                           (256, 8192), (8192, 4096))]
    for m, k, n in cases:
        for dt in ((torch.bfloat16, torch.float32) if (m, k, n) ==
                   (4, 768, 768) else (torch.bfloat16,)):
            w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
            qp = compute_qparams(w, 4, gs)
            packed = pack_int4(quantize_codes(w, qp, 4, gs))
            x = torch.randn((m, k), generator=g, device=dev).to(dt)
            want = ref.w4a16_matmul(x, packed, qp.scales, qp.zeros, gs)
            got = ops.w4a16_matmul_cuda(x, packed, qp.scales, qp.zeros,
                                        gs)
            # a split-K launch sums its partials in split order: a second
            # launch on the same inputs is bitwise the same
            splits = (ops.w4a16_matmul_geometry(m, n, k, gs)[2]
                      if dt == torch.bfloat16 else 1)
            same = splits == 1 or torch.equal(got, ops.w4a16_matmul_cuda(
                x, packed, qp.scales, qp.zeros, gs))
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dt == torch.float32:
                ok = err <= 1e-5 * float(want.abs().max())
                tol_s = "1e-5 rel"
            else:
                ok = within_bf16_ulp(diff, want)
                tol_s = "1 bf16 ulp"
            esz = 2 if dt == torch.bfloat16 else 4
            nbytes = (n * k / 2 + 2 * n * (k / gs) * 4 + m * k * esz
                      + m * n * esz)
            # distinct weight copies, 100 MB in all: each call reads
            # its weights from device memory, not from L2
            copies = [(packed, qp.scales, qp.zeros)] + [
                (packed.clone(), qp.scales.clone(), qp.zeros.clone())
                for _ in range(min(255, int(100e6 // nbytes)))]
            ms = graph_ms([
                (lambda c=c: ops.w4a16_matmul_cuda(x, *c, gs))
                for c in copies])
            pms = graph_ms([
                (lambda c=c: ref.w4a16_matmul(x, *c, gs))
                for c in copies])
            del copies
            lib_s = "none"
            if dt == torch.bfloat16:
                lms, lib_err = int4pack_yardstick(x, packed, qp.scales,
                                                  qp.zeros, gs, want, nbytes)
                lib_s = f"{lms:.4f} ({lib_err})"
                # bf16 x runs on the tensor cores: the bf16 rate bounds it
                b_ms, by = table.add("w4a16_matmul", ms=ms,
                                     plain_ms=pms, flop=2 * m * n * k,
                                     nbytes=nbytes, err=err, library_ms=lms,
                                     peak=H100_BF16_FLOPS)
            else:
                b_ms, by = bound(2 * m * n * k, nbytes, H100_FP32_FLOPS)
            log(f"  w4a16_matmul m={m} k={k} n={n} {dt}: "
                f"max_abs_err={err:.3e} ({tol_s}) ms={ms:.4f} "
                f"plain_ms={pms:.4f} library_ms={lib_s} "
                f"bound_ms={b_ms:.4f} ({by}); k splits {splits}, two "
                f"launches bitwise equal {same}")
            check(ok and same, f"w4a16_matmul m={m} k={k} n={n} {dt}")
    kernels_w4a16_other_groups()

    # -- gptq_block and rpiq_block on realistic Hessians ---------------------
    # opt-proxy's three groups, internlm2's q / o, k+v, gate+up, down, then
    # falcon-mamba's in, x (288 rows: dt_rank 256 + 2 x 16), dt, out
    for b, out_dim, in_dim in ((4, 768, 768), (1, 3072, 768),
                               (1, 768, 3072), (1, 2048, 2048),
                               (2, 1024, 2048), (2, 8192, 2048),
                               (1, 2048, 8192), (1, 16384, 4096),
                               (1, 288, 8192), (1, 8192, 256),
                               (1, 4096, 8192)):
        case = group_case(g, b, out_dim, in_dim, n_tok)
        w0, scales, zeros = check_gptq(case, gs, bs, table)
        check_rpiq(case, w0, scales, zeros, gs, bs, t_max, alpha, table)
    kernels_rpiq_seeds(n_tok, gs, bs, t_max, alpha)
    kernels_blocksizes(n_tok, gs, t_max, alpha)

    kernels_int8_kv_attention(table, g)
    kernels_quant_pack(table, g)
    kernels_selective_scan(table, g)


def group_case(g, b: int, out_dim: int, in_dim: int, n_tok: int) -> dict:
    """A stacked group of B linears (out, in) on n_tok calibration tokens
    drawn from generator g: x, w, the damped Hessian and its inverse
    Cholesky factor, as the quantizer hands them to the kernels."""
    import torch
    from repro_torch.core import hessian as hess
    dev = torch.device("cuda")
    x = torch.randn((b, n_tok, in_dim), generator=g, device=dev)
    w = torch.randn((b, out_dim, in_dim), generator=g, device=dev) \
        * in_dim ** -0.5
    H = x.transpose(1, 2) @ x
    count = torch.full((b,), n_tok, dtype=torch.int32, device=dev)
    hd = hess.damped(hess.HessianState(H, count),
                     torch.full((b,), 0.01, device=dev))
    return dict(x=x, w=w, hd=hd, count=count,
                u=hess.cholesky_inverse_upper(hd))


def check_gptq(case: dict, gs: int, bs: int, table=None):
    """gptq_block against its plain version on one group at phase 3's pins;
    timed (and added to ``table``) where a table is given. Returns the
    plain version's (w_q, scales, zeros), rpiq_block's inputs."""
    from repro_torch.core import hessian as hess
    from repro_torch.kernels import ops, ref
    w, u, hd = case["w"], case["u"], case["hd"]
    b, out_dim, in_dim = w.shape
    kw = dict(bits=4, group_size=gs, blocksize=bs, symmetric=False)
    want = ref.gptq_block(w, u, **kw)
    got = ops.gptq_block_cuda(w, u, **kw)
    fw = frac_differing(got[0], want[0], tol_abs=1e-6)
    fs = frac_differing(got[1], want[1], tol_rel=1e-6)
    fz = frac_differing(got[2], want[2], tol_abs=0.0)
    # a grid cell that flips moves the rest of its row, and the scales
    # of that row's later groups with it: rows with no flipped cell
    # hold their scales to 1e-6 rel
    differs = (got[0] - want[0]).abs() > 1e-6
    clean = ~differs.any(dim=-1)
    s_rel = ((got[1] - want[1]).abs() / want[1].abs())[clean]
    s_clean = float(s_rel.max()) if s_rel.numel() else 0.0
    # where a row first differs, a value within float rounding of a
    # rounding tie went to the neighbouring code: exactly one grid step
    bi, ri = (~clean).nonzero(as_tuple=True)
    fc = differs.float().argmax(dim=-1)[bi, ri]
    steps = ((got[0] - want[0]).abs()[bi, ri, fc]
             / want[1][bi, ri, fc // gs])
    one_step = bool(((steps - 1.0).abs() <= 1e-3).all())
    origins = bi.numel() / w.numel()
    err = float((got[0] - want[0]).abs().max())
    e_rel = float(((got[3].sum(1) - want[3].sum(1)).abs()
                   / want[3].sum(1).abs()).max())
    # in-block propagation: column j of a block updates bs-j-1 columns
    # (a product and a difference each); the tail update is a rank-bs
    # product
    flop = b * out_dim * in_dim * (bs - 1) + sum(
        2 * b * out_dim * bs * (in_dim - c2)
        for c2 in range(bs, in_dim + 1, bs))
    nbytes = 4 * (2 * b * out_dim * in_dim + b * in_dim * in_dim
                  + 2 * b * out_dim * (in_dim // gs) + b * out_dim)
    timing = ""
    if table is not None:
        chol_ms = time_ms(lambda: hess.cholesky_inverse_upper(hd), 0.1, 5)
        ms = time_ms(lambda: ops.gptq_block_cuda(w, u, **kw), 0.1, 5)
        pms = time_ms(lambda: ref.gptq_block(w, u, **kw), 0.1, 2)
        b_ms, by = table.add("gptq_block", ms=ms, plain_ms=pms, flop=flop,
                             nbytes=nbytes, err=err)
        timing = (f" ms={ms:.4f} plain_ms={pms:.4f} library_ms=none "
                  f"bound_ms={b_ms:.4f} ({by}); stage-1 factorization "
                  f"(library Cholesky x2 + solve) ms={chol_ms:.4f}")
    # opt-proxy's groups also keep their first pins on the cells a flip
    # carries along its row; how many that is depends on where in the
    # row the flips fall and grows with in, so the internlm2 and
    # falcon-mamba groups are held by the flips themselves
    spread_pinned = (b, out_dim, in_dim) in ((4, 768, 768),
                                            (1, 3072, 768),
                                            (1, 768, 3072))
    # a group's scale comes from running weights that the tail update's
    # in-term fp32 sums feed; their rounding grows like sqrt(in): 8.7e-7
    # at in 3072 becomes ~1.4e-6 at in 8192
    s_tol = 1e-6 if in_dim <= 3072 else 2e-6
    log(f"  gptq_block B={b} out={out_dim} in={in_dim} blocksize={bs}: "
        f"rows whose "
        f"first difference is one grid step: {bi.numel()} of "
        f"{b * out_dim} all one step {one_step}, flip origins per cell "
        f"{origins:.2e} (tol 1e-5); w_q cells differing >1e-6: "
        f"{fw:.2e}, scales >1e-6 rel: {fs:.2e}, zeros: {fz:.2e} ("
        f"{'tol 1e-3 each' if spread_pinned else 'carried by flips'}); "
        f"scales in rows with no flipped cell: max rel {s_clean:.2e} "
        f"(tol {s_tol:.0e}); sum err^2 rel {e_rel:.2e} (tol 1e-3); "
        f"max_abs_err={err:.3e}{timing}")
    spread_ok = fw <= 1e-3 and fs <= 1e-3 and fz <= 1e-3
    check(one_step and origins <= 1e-5 and s_clean <= s_tol
          and e_rel <= 1e-3 and (spread_ok or not spread_pinned),
          f"gptq_block {b}x{out_dim}x{in_dim} blocksize {bs}")
    return want[0], want[1], want[2]


def check_rpiq(case: dict, w0, scales, zeros, gs: int, bs: int, t_max: int,
               alpha: float, table=None, label: str = "",
               cross_gamma: bool = True, cross_yq: bool = True) -> bool:
    """rpiq_block against its plain version on one group at phase 3's pins
    (``check`` stops the run on a miss); timed (and added to ``table``)
    where a table is given. ``cross_gamma=False`` / ``cross_yq=False``
    report the kernel's Gamma / final Y_q against the plain version's
    without holding them to their pins: both follow the two sides'
    iterates, which the cell pins hold, and each side's Gamma is still
    held to the exact Gamma of its own iterate (so its Y_q to its own
    w_cont). Returns whether the Gamma pin held."""
    from repro_torch.core.rpiq import _block_curvature_inv
    from repro_torch.kernels import ops, ref
    x, w, hd, count = case["x"], case["w"], case["hd"], case["count"]
    b, out_dim, in_dim = w.shape
    n_tok = x.shape[1]
    hinv = _block_curvature_inv(x, hd, count, count, block_size=bs,
                                exact_gram=False)
    y_orig = x @ w.transpose(1, 2)
    s_full = scales.repeat_interleave(gs, dim=-1)
    z_full = zeros.repeat_interleave(gs, dim=-1)
    hinv_flat = hinv.reshape(b, in_dim, bs).contiguous()
    rargs = (w0, y_orig, x, hinv_flat, s_full, z_full)
    rkw = dict(bits=4, block_size=bs, alpha=alpha, t_max=t_max,
               symmetric=False)
    want_r = ref.rpiq_block(*rargs, **rkw)
    got_r = ops.rpiq_block_cuda(*rargs, **rkw)
    sel_w = ops._rpiq_select(want_r[3], want_r[4], want_r[1], t_max,
                             True)
    sel_g = ops._rpiq_select(got_r[3], got_r[4], got_r[1], t_max, True)
    fwq = frac_differing(sel_g[0], sel_w[0], tol_abs=1e-6)
    fwp = frac_differing(got_r[1], want_r[1], tol_abs=1e-6)
    fwc = frac_differing(got_r[0], want_r[0], tol_abs=1e-6)
    yq_rel = float((got_r[2] - want_r[2]).norm() / want_r[2].norm())
    h_rel = float(((got_r[3] - want_r[3]).abs()
                   / want_r[3].abs()).max())
    p_rel = float(((got_r[4] - want_r[4]).abs()
                   / want_r[4].abs()).max())
    iters_eq = bool((sel_g[3] == sel_w[3]).all())
    err = float((sel_g[0] - sel_w[0]).abs().max())
    n_m = in_dim // bs
    flop = b * (2 * n_tok * in_dim * out_dim * (1 + t_max)
                + t_max * (6 * n_tok * in_dim * out_dim
                           + 2 * bs * in_dim * out_dim))
    nbytes = 4 * b * (3 * out_dim * in_dim + n_tok * out_dim
                      + n_tok * in_dim + n_m * bs * bs
                      + out_dim * in_dim * (t_max + 2)
                      + n_tok * out_dim)
    timing = ""
    if table is not None:
        curv_ms = time_ms(lambda: _block_curvature_inv(
            x, hd, count, count, block_size=bs, exact_gram=False), 0.1, 5)
        ms = time_ms(lambda: ops.rpiq_block_cuda(*rargs, **rkw), 0.1, 5)
        pms = time_ms(lambda: ref.rpiq_block(*rargs, **rkw), 0.1, 5)
        b_ms, by = table.add("rpiq_block", ms=ms, plain_ms=pms, flop=flop,
                             nbytes=nbytes, err=err)
        timing = (f" ms={ms:.4f} plain_ms={pms:.4f} library_ms=none "
                  f"bound_ms={b_ms:.4f} ({by}); stage-2 block curvature "
                  f"(library) ms={curv_ms:.4f}")
    # Gamma = |y_orig - Y_q|^2 sees a difference d in Y_q (the final
    # Y_q rel above) through the residual r: 2<r, d>/|r|^2, where a
    # random d meets r at a cosine ~ 1/sqrt(n x out). The 1e-5 pin was
    # set on the groups of 512 x 768 cells and more; fewer cells scale
    # it by the square root of the ratio (1.63e-5 at falcon-mamba's
    # 288-row x projection)
    g_tol = 1e-5 * max(1.0, (768 * 512 / (out_dim * n_tok)) ** 0.5)
    # the second witness: each side's last-round Gamma against the
    # exact (fp64) Gamma of its own last iterate w_cont, held to 1e-6
    # (fp32 sums of n x out squares and Y_q's drift from X w_cont^T);
    # the two exact values differ as the two iterates do
    x64, y64 = x.double(), y_orig.double()
    g64 = [((y64 - x64 @ w_c.double().transpose(1, 2)) ** 2).sum((1, 2))
           for w_c in (got_r[0], want_r[0])]
    e_k, e_p = (float(((side[3][:, t_max].double() - g).abs() / g).max())
                for side, g in zip((got_r, want_r), g64))
    e_64 = float(((g64[0] - g64[1]).abs() / g64[1]).max())
    del x64, y64, g64
    log(f"  rpiq_block{label} B={b} out={out_dim} in={in_dim} n={n_tok} "
        f"blocksize={bs}: "
        f"selected w_q cells differing >1e-6: {fwq:.2e}, candidates: "
        f"{fwp:.2e}, w_cont: {fwc:.2e} (tol 1e-3 each); final Y_q rel "
        f"{yq_rel:.2e} (tol 1e-4); Gamma rel "
        f"{h_rel:.2e} (tol {g_tol:.3g}), proj-loss rel "
        f"{p_rel:.2e} (tol 1e-5); last-round Gamma against the fp64 "
        f"Gamma of its own w_cont: kernel {e_k:.2e}, plain {e_p:.2e} "
        f"(tol 1e-6 each), the two fp64 values {e_64:.2e}; "
        f"iters equal {iters_eq} "
        f"({sel_g[3].tolist()}); max_abs_err={err:.3e}{timing}")
    check(fwq <= 1e-3 and fwp <= 1e-3 and fwc <= 1e-3
          and (yq_rel <= 1e-4 or not cross_yq)
          and (h_rel <= g_tol or not cross_gamma) and p_rel <= 1e-5
          and iters_eq and e_k <= 1e-6 and e_p <= 1e-6,
          f"rpiq_block{label} {b}x{out_dim}x{in_dim} blocksize {bs}")
    return h_rel <= g_tol


def kernels_rpiq_seeds(n_tok: int, gs: int, bs: int, t_max: int,
                       alpha: float, seeds: int = 8) -> None:
    """rpiq_block on ``seeds`` instances of its two narrowest groups, each
    drawn from a generator of its own: falcon-mamba's 288-row x projection
    (1, 288, 8192), where Gamma's pin is widest, and opt-proxy's (4, 768,
    768). Every phase-3 pin is held, except that at 288 rows the kernel's
    Gamma against the plain version's is reported, not held: there the two
    sides' iterates (which differ in fp32 rounding, and the kernel's stays
    bitwise the earlier kernel's) have exact Gammas as far apart as that
    pin (the line's 'two fp64 values'), so it measures the iterates, which
    the cell and Y_q pins hold, and not the kernel's Gamma, which is held
    to 1e-6 of its own iterate's exact Gamma."""
    import torch
    for b, out_dim, in_dim in ((1, 288, 8192), (4, 768, 768)):
        held = 0
        for seed in range(seeds):
            g = torch.Generator(device="cuda")
            g.manual_seed(seed)
            case = group_case(g, b, out_dim, in_dim, n_tok)
            w0, scales, zeros = check_gptq(case, gs, bs)
            held += check_rpiq(case, w0, scales, zeros, gs, bs, t_max, alpha,
                               label=f" seed {seed}",
                               cross_gamma=out_dim != 288)
        log(f"  rpiq_block B={b} out={out_dim} in={in_dim}: the kernel's "
            f"Gamma within its pin of the plain version's on {held} of "
            f"{seeds} seeds")


def kernels_blocksizes(n_tok: int, gs: int, t_max: int,
                       alpha: float) -> None:
    """gptq_block and rpiq_block at lazy blocks above 128 columns, which
    the reference takes (``in % blocksize == 0``, ``blocksize %
    group_size == 0``): 256 and the whole row (blocksize = in) on
    opt-proxy's three groups, at phase 3's pins, except that at blocksize
    = in rpiq_block's final Y_q and Gamma against the plain version's are
    reported, not held: one solve over the whole row rounds differently in
    the two summation orders, so more intermediate projections flip by a
    grid step (within the w_cont pin), each moving Y_q by alpha·s·x and
    Gamma with it (each side's Gamma is still held to 1e-6 of its own
    iterate's exact Gamma). Their times beside the fused kernels' at
    128."""
    import torch
    from repro_torch.core.rpiq import _block_curvature_inv
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    for b, out_dim, in_dim in ((4, 768, 768), (1, 3072, 768),
                               (1, 768, 3072)):
        case = group_case(g, b, out_dim, in_dim, n_tok)
        x, w, hd, count = case["x"], case["w"], case["hd"], case["count"]
        for bs in (128, 256, in_dim):
            if bs != 128:
                w0, scales, zeros = check_gptq(case, gs, bs)
                check_rpiq(case, w0, scales, zeros, gs, bs, t_max, alpha,
                           cross_gamma=bs != in_dim, cross_yq=bs != in_dim)
            gkw = dict(bits=4, group_size=gs, blocksize=bs, symmetric=False)
            g_ms = time_ms(lambda: ops.gptq_block_cuda(w, case["u"], **gkw),
                           0.1, 3)
            w0, sc, zr, _ = ops.gptq_block_cuda(w, case["u"], **gkw)
            hinv = _block_curvature_inv(x, hd, count, count, block_size=bs,
                                        exact_gram=False)
            rargs = (w0, x @ w.transpose(1, 2), x,
                     hinv.reshape(b, in_dim, bs).contiguous(),
                     sc.repeat_interleave(gs, -1),
                     zr.repeat_interleave(gs, -1))
            rkw = dict(bits=4, block_size=bs, alpha=alpha, t_max=t_max,
                       symmetric=False)
            r_ms = time_ms(lambda: ops.rpiq_block_cuda(*rargs, **rkw), 0.1,
                           3)
            log(f"  blocksize {bs}, B={b} out={out_dim} in={in_dim}: "
                f"gptq_block ms={g_ms:.4f} rpiq_block ms={r_ms:.4f}")



def int4pack_yardstick(x, packed, scales, zeros, gs, want, nbytes):
    """The library's one call for y = x @ dequant(W)^T on bf16 x:
    ``torch.ops.aten._weight_int4pack_mm`` on the weights repacked once
    by ``_convert_weight_to_int4pack``. Its packed input holds the even
    column in the high nibble (``torch.testing._internal.
    common_quantization._group_quantize_tensor``; ours: the low one) and
    dequantizes (q - 8)·s + zero' from a (k/g, n, 2) bf16 table, so zero'
    = (8 - z)·s. Held against the plain version: per output, at most 2^-8
    (bf16 rounding of s, zero' and the dequantized weight) of
    sum_k |x| (|q - 8| s + |zero'| + |w|), plus one bf16 ulp of the
    output. Timed from a CUDA graph over weight copies beyond L2, as the
    kernel. Returns (ms, the reading); the port never calls it."""
    import torch
    swapped = ((packed & 0x0F) << 4) | (packed >> 4)
    w_pk = torch.ops.aten._convert_weight_to_int4pack(swapped, 8)
    zp = (8.0 - zeros) * scales
    sz = torch.stack([scales, zp], dim=-1).transpose(0, 1).contiguous() \
        .to(torch.bfloat16)
    got = torch.ops.aten._weight_int4pack_mm(x, w_pk, gs, sz).float()
    q = torch.stack([packed & 0x0F, packed >> 4], -1).reshape(
        packed.shape[0], -1).float()
    s_f = scales.repeat_interleave(gs, 1)
    z_f = zp.repeat_interleave(gs, 1)
    w = (q - zeros.repeat_interleave(gs, 1)) * s_f
    slack = x.float().abs() @ ((q - 8).abs() * s_f + z_f.abs()
                               + w.abs()).T * 2.0 ** -8
    wf = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(wf.abs().clamp_min(1e-30))) - 7)
    excess = float(((got - wf).abs() - slack - ulp).max())
    check(excess <= 0, f"int4pack yardstick: |library - plain| exceeds "
          f"its bf16 bound by {excess:.3e}")
    copies = [(w_pk, sz)] + [(w_pk.clone(), sz.clone())
                             for _ in range(min(255, int(100e6 // nbytes)))]
    ms = graph_ms([(lambda c=c: torch.ops.aten._weight_int4pack_mm(
        x, c[0], gs, c[1])) for c in copies])
    return ms, (f"|library - plain| within its bf16 bound, largest "
                f"{float((got - wf).abs().max()):.3e}")


def kernels_w4a16_other_groups() -> None:
    """bf16 w4a16_matmul at the smoke configs' group sizes, 8 and 16 (the
    tensor cores' m16n8k8 steps), at opt-proxy's smoke shapes and its
    full-width (768, 768) and (3072, 768), m 4 and 64, within one bf16 ulp
    of the plain version (a split-K launch twice, bitwise equal); and fp32
    x at k 12288 (x staged in 8192-column chunks) within 1e-5 of the
    largest output. Checks only: these shapes are off the main paths'.
    Their inputs come from a generator of their own, so the checks that
    follow draw the same inputs as before these were added."""
    import torch
    from repro_torch.core.quant import compute_qparams, pack_int4, \
        quantize_codes
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    for gs in (8, 16):
        for m in (4, 64):
            for k, n in ((64, 64), (64, 256), (256, 64), (768, 768),
                         (3072, 768)):
                w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
                qp = compute_qparams(w, 4, gs)
                args = (pack_int4(quantize_codes(w, qp, 4, gs)), qp.scales,
                        qp.zeros)
                x = torch.randn((m, k), generator=g, device=dev).to(
                    torch.bfloat16)
                want = ref.w4a16_matmul(x, *args, gs)
                got = ops.w4a16_matmul_cuda(x, *args, gs)
                splits = ops.w4a16_matmul_geometry(m, n, k, gs)[2]
                same = splits == 1 or torch.equal(
                    got, ops.w4a16_matmul_cuda(x, *args, gs))
                ulps = bf16_ulps(got.float() - want.float(), want)
                timing = ""
                if k >= 768:
                    ms = graph_ms([lambda: ops.w4a16_matmul_cuda(x, *args,
                                                                 gs)])
                    timing = f" ms={ms:.4f} (operands in L2)"
                log(f"  w4a16_matmul bf16 m={m} k={k} n={n} g={gs}: "
                    f"{ulps:.3g} bf16 ulps (tol 1); k splits {splits}, two "
                    f"launches bitwise equal {same}{timing}")
                check(ulps <= 1.0 and same,
                      f"w4a16_matmul bf16 m={m} k={k} n={n} g={gs}")
    for m, k, n in ((4, 12288, 768), (64, 12288, 288)):
        w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        qp = compute_qparams(w, 4, 128)
        args = (pack_int4(quantize_codes(w, qp, 4, 128)), qp.scales,
                qp.zeros)
        x = torch.randn((m, k), generator=g, device=dev)
        want = ref.w4a16_matmul(x, *args, 128)
        got = ops.w4a16_matmul_cuda(x, *args, 128)
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        log(f"  w4a16_matmul fp32 m={m} k={k} n={n} g=128: max_abs_err="
            f"{err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"w4a16_matmul fp32 m={m} k={k} n={n}")


def kernels_int8_kv_attention(table: KernelTable, g) -> None:
    """The decode attention over an int8 cache at internlm2's shape (B 4,
    KV 8, R 2, hd 128): the serving path's S 545 and a long history S 4096
    at kv_block 128 and 64, kpos with -1 holes and a lane with no valid
    slot. Held in fp32 (1e-5 of the largest output) and bf16, the path's
    dtype (one bf16 ulp), a second launch bitwise the first, and timed in
    bf16 from a CUDA graph over cache copies beyond L2, as a decode step's
    24 layers read theirs. Then, checks only: S 77 (one history range) and
    S 4096 with only its first 600 slots valid (every later range holds
    -1 slots only, as a long preallocated cache early in decode)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import kv_codec, ops, ref

    dev = torch.device("cuda")
    b, kv, r, hd = 4, 8, 2, 128
    # the checks-only rows draw from a generator of their own, so the
    # kernels after this one draw the same inputs as before they were added
    g_extra = torch.Generator(device=dev)
    g_extra.manual_seed(4322)
    for s, blk, valid in ((545, 128, None), (4096, 128, None),
                          (4096, 64, None), (77, 128, None),
                          (4096, 128, 600)):
        nb = hd // blk
        if s == 77:
            g = g_extra
        x = torch.randn((2, b, s, kv, hd), generator=g, device=dev)
        kc, ks = kv_codec.enc_int8_blocks(x[0], blk)
        vc, vs = kv_codec.enc_int8_blocks(x[1], blk)
        kpos = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
        holes = torch.rand((b, s), generator=g, device=dev) < 0.1
        kpos = torch.where(holes, torch.full_like(kpos, -1), kpos)
        kpos[-1] = -1
        if valid is not None:
            kpos[:, valid:] = -1
        q32 = torch.randn((b, kv, r, hd), generator=g, device=dev) \
            * hd ** -0.5
        cache = (kc, ks, vc, vs, kpos)
        want = ref.int8_kv_attention(q32, *cache, blk)
        got = ops.int8_kv_attention_cuda(q32, *cache, blk)
        err32 = float((got - want).abs().max())
        ok32 = err32 <= 1e-5 * float(want.abs().max())
        q = q32.to(torch.bfloat16)
        want = ref.int8_kv_attention(q, *cache, blk)
        got = ops.int8_kv_attention_cuda(q, *cache, blk)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = within_bf16_ulp(diff, want)
        zero = float(got[-1].abs().max()) == 0.0
        # the history ranges combine in range order, no float atomics
        same = torch.equal(got, ops.int8_kv_attention_cuda(q, *cache, blk))
        splits, per = ops.int8_kv_attention_geometry(b, kv, s)
        if valid is not None or s == 77:
            log(f"  int8_kv_attention B={b} S={s} KV={kv} R={r} hd={hd} "
                f"kv_block={blk}"
                + (f", slots {valid}.. invalid" if valid else "")
                + f": {splits} history ranges of {per} tiles; fp32 "
                f"max_abs_err={err32:.3e} (tol 1e-5 rel) bf16 max_abs_err="
                f"{err:.3e} (1 bf16 ulp); lane with no valid slot is 0: "
                f"{zero}; two launches bitwise equal {same}")
            check(ok32 and ok and zero and same and (splits == 1) == (
                s == 77), f"int8_kv_attention S={s} valid={valid}")
            continue
        # each input read once, each output written once
        nbytes = (2 * b * s * kv * hd + 2 * b * s * kv * nb * 4 + 4 * b * s
                  + 2 * 2 * b * kv * r * hd)
        flop = 4 * b * kv * r * s * hd
        copies = [cache] + [tuple(t.clone() for t in cache)
                            for _ in range(int(100e6 // nbytes))]
        ms = graph_ms([(lambda c=c: ops.int8_kv_attention_cuda(q, *c, blk))
                       for c in copies])
        pms = graph_ms([(lambda c=c: ref.int8_kv_attention(q, *c, blk))
                        for c in copies])
        del copies
        # aside: the bf16-cache attention the int8 cache replaces, through
        # the library's fused attention (not a yardstick of this function)
        kb = kv_codec.dec_int8_blocks(kc, ks, blk).to(torch.bfloat16)
        vb = kv_codec.dec_int8_blocks(vc, vs, blk).to(torch.bfloat16)
        kb, vb = (t.transpose(1, 2).contiguous() for t in (kb, vb))
        mask = (kpos >= 0)[:, None, None, :]
        qh = q.reshape(b, kv * r, 1, hd)
        bf16_copies = [(kb, vb)] + [
            (kb.clone(), vb.clone())
            for _ in range(int(100e6 // (4 * kb.numel())))]
        sdpa_calls = [(lambda c=c: F.scaled_dot_product_attention(
            qh, c[0], c[1], attn_mask=mask, scale=1.0, enable_gqa=True))
            for c in bf16_copies]
        try:
            sdpa = f"{graph_ms(sdpa_calls):.4f}"
        except RuntimeError as e:       # an aside: report, do not stop
            sdpa = f"not measured ({type(e).__name__}: {str(e)[:80]})"
        del bf16_copies
        b_ms, by = table.add("int8_kv_attention", ms=ms, plain_ms=pms,
                             flop=flop, nbytes=nbytes, err=err)
        log(f"  int8_kv_attention B={b} S={s} KV={kv} R={r} hd={hd} "
            f"kv_block={blk}: {splits} history ranges of {per} tiles; fp32 "
            f"max_abs_err={err32:.3e} (tol 1e-5 rel) "
            f"bf16 max_abs_err={err:.3e} (1 bf16 ulp); lane with no valid "
            f"slot is 0: {zero}; two launches bitwise equal {same}; "
            f"ms={ms:.4f} plain_ms={pms:.4f} "
            f"library_ms=none bound_ms={b_ms:.4f} ({by}); aside, "
            f"scaled_dot_product_attention on a bf16 cache of the same "
            f"shape ms={sdpa}")
        check(ok32 and ok and zero and same,
              f"int8_kv_attention S={s} block={blk}")


def kernels_quant_pack(table: KernelTable, g) -> None:
    """The int4 packer at internlm2's widest shapes and falcon-mamba's four
    (in, x, dt, out), fp32 weights as pack_for_serving gives them, half the
    cells exactly on a .5 tie of w / s; bitwise against the plain version
    and the older packer, and the same weights in bf16 bitwise against the
    plain version."""
    import torch
    from repro_torch.core.quant import QuantParams, pack_int4, \
        quantize_codes
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gs = 128
    for n, k in ((2048, 8192), (8192, 2048), (16384, 4096), (288, 8192),
                 (8192, 256), (4096, 8192)):
        scales = torch.exp2(torch.randint(-8, -4, (n, k // gs), generator=g,
                                          device=dev).float())
        zeros = torch.randint(0, 16, (n, k // gs), generator=g,
                              device=dev).float()
        s_full = scales.repeat_interleave(gs, dim=1)
        ties = (torch.randint(-12, 12, (n, k), generator=g, device=dev)
                + 0.5) * s_full
        free = torch.randn((n, k), generator=g, device=dev) * 8 * s_full
        w = torch.where(torch.rand((n, k), generator=g, device=dev) < 0.5,
                        ties, free)
        want = ref.quant_pack(w, scales, zeros, gs)
        got = ops.quant_pack_cuda(w, scales, zeros, gs)
        older = pack_int4(quantize_codes(w, QuantParams(scales, zeros), 4,
                                         gs))
        n_diff = int((got != want).sum())
        err = float((got.int() - want.int()).abs().max())
        same = n_diff == 0 and torch.equal(want, older)
        nbytes = 4 * n * k + 8 * n * k / gs + n * k / 2
        args = (w, scales, zeros)
        copies = [args] + [tuple(t.clone() for t in args)
                           for _ in range(int(100e6 // nbytes))]
        ms = graph_ms([(lambda c=c: ops.quant_pack_cuda(*c, gs))
                       for c in copies])
        pms = graph_ms([(lambda c=c: ref.quant_pack(*c, gs))
                        for c in copies])
        del copies
        b_ms, by = table.add("quant_pack", ms=ms, plain_ms=pms,
                             flop=4 * n * k, nbytes=nbytes, err=err)
        w16 = w.to(torch.bfloat16)
        same16 = torch.equal(ops.quant_pack_cuda(w16, scales, zeros, gs),
                             ref.quant_pack(w16, scales, zeros, gs))
        log(f"  quant_pack n={n} k={k} fp32 g={gs}: bytes differing from "
            f"the plain version {n_diff} (tol 0; plain equals the older "
            f"packer: {torch.equal(want, older)}) ms={ms:.4f} "
            f"plain_ms={pms:.4f} library_ms=none bound_ms={b_ms:.4f} "
            f"({by}, {b_ms / ms:.2f} of it); bf16 weights bitwise equal to "
            f"the plain version {same16}")
        check(same and same16, f"quant_pack {n}x{k}")


def kernels_selective_scan(table: KernelTable, g) -> None:
    """The Mamba-1 scan at falcon-mamba-7b's prefill (S 512) and
    calibration (S 128) shapes and a ragged S 77: B 4, d 8192, n 16,
    nonzero h0, dt > 0 as softplus gives it. u in fp32 (y and h_last within
    1e-5 of their largest value) and in bf16, the path's dtype (y within
    one bf16 ulp, h_last within 1e-5); timed in bf16 from a CUDA graph over
    input copies beyond the 50 MB L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    b, d, n = 4, 8192, 16
    for s in (512, 128, 77):
        u = torch.randn((b, s, d), generator=g, device=dev)
        dt = F.softplus(torch.randn((b, s, d), generator=g, device=dev) - 1)
        bm, cm = (torch.randn((b, s, n), generator=g, device=dev)
                  for _ in range(2))
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=dev)).repeat(d, 1)
        d_skip = torch.randn((d,), generator=g, device=dev)
        h0 = torch.randn((b, d, n), generator=g, device=dev) * 0.1
        rest = (dt, bm, cm, a_log, d_skip, h0)
        errs, ok = {}, True
        for name, udt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            uu = u.to(udt)
            y_want, h_want = ref.selective_scan(uu, *rest)
            y_got, h_got = ops.selective_scan_cuda(uu, *rest)
            ydiff = (y_got.float() - y_want.float()).abs()
            y_rel = float(ydiff.max()) / float(y_want.float().abs().max())
            h_rel = float((h_got - h_want).abs().max()) \
                / float(h_want.abs().max())
            y_ok = (y_rel <= 1e-5 if udt == torch.float32
                    else within_bf16_ulp(ydiff, y_want))
            ok = ok and y_ok and h_rel <= 1e-5
            errs[name] = (float(ydiff.max()), y_rel, h_rel, y_ok)
        # bf16 u and y, fp32 dt / B / C / a_log / d_skip / h0 / h_last
        nbytes = (b * s * d * (2 + 4 + 2) + 2 * b * s * n * 4
                  + d * n * 4 + d * 4 + 2 * b * d * n * 4)
        flop = 7 * b * s * d * n
        timing = ""
        if s in (512, 128):
            args = (u.to(torch.bfloat16),) + rest
            copies = [args] + [tuple(t.clone() for t in args)
                               for _ in range(int(100e6 // nbytes))]
            ms = graph_ms([(lambda c=c: ops.selective_scan_cuda(*c))
                           for c in copies])
            del copies
            pms = time_ms(lambda: ref.selective_scan(*args), 0.2, 5)
            b_ms, by = table.add("selective_scan", ms=ms, plain_ms=pms,
                                 flop=flop, nbytes=nbytes,
                                 err=errs["bf16"][0])
            timing = (f" ms={ms:.4f} plain_ms={pms:.4f} library_ms=none "
                      f"bound_ms={b_ms:.4f} ({by})")
        f32, b16 = errs["fp32"], errs["bf16"]
        log(f"  selective_scan B={b} S={s} d={d} n={n}: fp32 y max_abs_err="
            f"{f32[0]:.3e} rel {f32[1]:.2e}, h_last rel {f32[2]:.2e} (tol "
            f"1e-5 each); bf16 y max_abs_err={b16[0]:.3e} within 1 bf16 "
            f"ulp {b16[3]}, h_last rel {b16[2]:.2e} (tol 1e-5){timing}")
        check(ok, f"selective_scan S={s}")


def phase_small_end_to_end(arch: str, kv_cache: str) -> None:
    """A smoke config in fp32: the card's run against the CPU plain run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.core.quant import quantized_leaves
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    cfg = get_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    cfg.serve.kv_cache = kv_cache
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, "cpu")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7),
                                3, 4, 32)
    prompt = MarkovLM(cfg.model.vocab_size, seed=3).batch(2, 8)
    runs = {}
    for dev in ("cpu", "cuda"):
        pq, rep = quantize_model(cfg, params, calib, device=dev)
        pk = pack_for_serving(cfg, pq)
        logits = T.forward(cfg.model, pk, calib[-1]["tokens"].to(dev))
        toks = generate(cfg, pk, prompt, device=dev, max_new_tokens=6)
        runs[dev] = (rep, pk, logits.cpu(), toks.tokens.cpu())
    (rc, pc, lc, tc), (rg, pg, lg, tg) = runs["cpu"], runs["cuda"]
    modes = all(a.mode == b.mode and a.iters == b.iters
                for a, b in zip(rc.linears, rg.linears))
    lin_c, lin_g = (dict(quantized_leaves(p["layers"])) for p in (pc, pg))
    codes = [(qt.packed, lin_g[k].packed) for k, qt in lin_c.items()]
    same_set = list(lin_c) == list(lin_g) and len(codes) > 0
    mism = sum(int((a != b.cpu()).sum()) for a, b in codes) / sum(
        a.numel() for a, _ in codes)
    rel = float((lg - lc).norm() / lc.norm())
    log(f"  {cfg.model.name} fp32 kv_cache={kv_cache}, card vs CPU plain: "
        f"modes/iters equal {modes}; the same {len(codes)} packed linears "
        f"{same_set}; packed-byte mismatch {mism:.2e} (tol "
        f"1e-2); packed logits rel {rel:.2e} (tol 1e-3); greedy tokens "
        f"equal {bool(torch.equal(tc, tg))}")
    check(modes and same_set and mism <= 1e-2 and rel <= 1e-3
          and torch.equal(tc, tg),
          f"small end to end {arch} kv_cache={kv_cache}, card against CPU "
          "plain")


def phase_small_bf16(arch: str, kv_cache: str) -> None:
    """A smoke config at its own dtype (bf16) and group size (opt-proxy
    16, internlm2 and falcon-mamba 8) on the card: quantize → pack →
    generate runs; the first layer's kernel calls on the packed model are
    held against their plain versions on the same inputs at phase 3's pin
    (one bf16 ulp)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    cfg = get_config(arch, smoke=True)
    cfg.serve.kv_cache = kv_cache
    mc = cfg.model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cpu")
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 3, 4, 32)
    n_req, n_prompt = 2, 8
    prompt = MarkovLM(mc.vocab_size, seed=3).batch(n_req, n_prompt)
    pq, rep = quantize_model(cfg, params, calib, device="cuda")
    pk = pack_for_serving(cfg, pq)
    toks = generate(cfg, pk, prompt, device="cuda", max_new_tokens=6)
    n_quant = sum(1 for rec in rep.linears if rec.mode != "skipped")
    ptoks = prompt["tokens"].cuda()
    h = T.embed(pk["embed"], ptoks, T.compute_dtype(mc))
    calls = []
    with paired_route(calls):
        h = T.layer_forward(mc, T.layer_specs(mc)[0], pk["layers"][0], h,
                            T.positions_for(n_req, n_prompt, "cuda"))
    worst = {op: max(v for o, v in calls if o == op)
             for op in sorted({o for o, _ in calls})}
    finite = bool(torch.isfinite(h.float()).all())
    log(f"  {mc.name} {mc.dtype} group {cfg.quant.group_size} kv_cache="
        f"{kv_cache} on the card: {n_quant} linears quantized; generate "
        f"gave tokens {tuple(toks.tokens.shape)}; layer 0: {len(calls)} "
        f"kernel calls against their plain versions, largest difference in "
        f"bf16 ulps { {k: f'{v:.3g}' for k, v in worst.items()} } (tol 1); "
        f"finite {finite}")
    check(mc.dtype == "bfloat16" and n_quant > 0
          and "w4a16_matmul" in worst and max(worst.values()) <= 1.0
          and finite and tuple(toks.tokens.shape) == (n_req, 6),
          f"small bf16 end to end {arch} kv_cache={kv_cache}")


def _nbytes_bf16_vs_int4(pk) -> tuple:
    from repro_torch.core.quant import quantized_leaves
    bf16 = int4 = 0
    for _, w in quantized_leaves(pk["layers"]):
        o, i = w.shape
        bf16 += 2 * o * i
        int4 += w.packed.numel() + 4 * w.scales.numel() + 4 * w.zeros.numel()
    return bf16, int4


def drive_main_path(arch: str, kv_cache: str, n_req: int, n_prompt: int,
                    n_new: int) -> dict:
    """A config at full width and depth from seeded random weights:
    quantize_model → pack_for_serving → generate, with the launch counters
    reset just before and read just after; prints the counters, walls,
    bytes and peak memory and returns what the checks need."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    cfg = get_config(arch)
    cfg.serve.kv_cache = kv_cache
    mc, qc = cfg.model, cfg.quant
    if "mamba" in mc.layer_kinds:
        widths = (f"kinds={mc.block_pattern} d_inner="
                  f"{mc.ssm.expand * mc.d_model} d_state={mc.ssm.d_state} "
                  f"d_conv={mc.ssm.d_conv} dt_rank={mc.ssm.dt_rank}")
    else:
        widths = (f"heads={mc.num_heads} kv_heads={mc.num_kv_heads} "
                  f"head_dim={mc.head_dim} d_ff={mc.d_ff}")
    log(f"  config: {mc.name} layers={mc.num_layers} d_model={mc.d_model} "
        f"{widths} vocab={mc.vocab_size} "
        f"dtype={mc.dtype}; quant group={qc.group_size} "
        f"blocksize={qc.blocksize} rpiq_iters={qc.rpiq_iters}; serve "
        f"kv_cache={kv_cache} (depth not cut)")
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cuda")
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 4, 4, 128)
    prompt = MarkovLM(mc.vocab_size, seed=3).batch(n_req, n_prompt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    params_q, report = quantize_model(cfg, params, calib)
    t1 = time.perf_counter()
    del params          # the original float layers: no longer needed
    packed = pack_for_serving(cfg, params_q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before_gen = ops.kernel_launches()
    res = generate(cfg, packed, prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    gen_launches = {k: launches[k] - before_gen[k] for k in launches}

    log(f"  kernels: {json.dumps(launches)}")
    log(f"  report: {report.summary()}")
    rest = report.seconds_total - report.seconds_stage1 \
        - report.seconds_stage2
    log(f"  walls (s): quantize_model={t1 - t0:.3f} (stage1="
        f"{report.seconds_stage1:.3f} stage2={report.seconds_stage2:.3f} "
        f"capture+propagate+rest={rest:.3f}) pack_for_serving="
        f"{t2 - t1:.3f} generate={t3 - t2:.3f} ({n_req} requests x "
        f"{n_prompt} prompt + {n_new} new tokens; its decode step's graph "
        f"capture {res.capture_s:.4f})")
    log(f"  layer step walls (s): "
        f"{[round(x, 3) for x in report.layer_step_seconds]}")
    bf16, int4 = _nbytes_bf16_vs_int4(packed)
    log(f"  quantized linear bytes: bf16 {bf16} vs int4+scales+zeros {int4}"
        f" ({bf16 / int4:.2f}x)")
    log(f"  peak device memory (the decode graph's pool in it): {peak} "
        f"bytes, of which {held_before} were held by earlier phases: this "
        f"path {peak - held_before} bytes")
    decode_graph_checks(cfg, packed, prompt, res, gen_launches, n_new)
    return dict(cfg=cfg, params_q=params_q, packed=packed, calib=calib,
                prompt=prompt, res=res, launches=launches, report=report)


def decode_graph_checks(cfg, packed, prompt, res, gen_launches: dict,
                        n_new: int, n_replays: int = 8) -> None:
    """generate's decode ran through a replayed CUDA graph: against the
    same ``DecodeLoop`` stepped eagerly on the same prompt (a fresh
    prefill), generate's tokens, steps and launch counts are equal; the
    logits of ``n_replays`` replayed steps are bitwise the eager steps';
    prints the decode step walls eager and replayed (host clock, each
    step synchronised), the capture wall, and a profiled replay's device
    time and idle share."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import engine

    toks = prompt["tokens"].cuda()
    s0 = toks.shape[1]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def fresh_loop():
        lg, caches = engine.prefill(cfg, packed, {"tokens": toks},
                                    s0 + n_new + 1)
        return engine.DecodeLoop(cfg, packed, lg, caches, s0, n_new, -1,
                                 0.0, None)

    before = ops.kernel_launches()
    loop = fresh_loop()
    eager_lg, eager_w = [], []
    for i in range(n_new - 1):
        lg, w = timed(loop.step)
        eager_w.append(w)
        if i <= n_replays:
            eager_lg.append(lg.clone())
    after = ops.kernel_launches()
    eager_counts = {k: after[k] - before[k] for k in after}
    same_tok = bool(torch.equal(loop.tokens, res.tokens)
                    and torch.equal(loop.steps, res.steps))
    same_counts = eager_counts == gen_launches
    del loop

    loop = fresh_loop()
    got_lg = [timed(loop.step)[0].clone()]
    graph, cap_s = timed(loop.capture)
    replay_w = []
    for _ in range(n_replays):
        replay_w.append(timed(graph.replay)[1])
        got_lg.append(loop.logits.clone())
    bitwise = len(got_lg) == len(eager_lg) and all(
        torch.equal(a, b) for a, b in zip(got_lg, eager_lg))
    eager_s = sum(eager_w[1:]) / (len(eager_w) - 1)
    replay_s = sum(replay_w) / len(replay_w)
    log(f"  decode graph: generate's tokens and steps equal the eager "
        f"loop's {same_tok}; generate's launches equal the eager loop's "
        f"{same_counts} ({json.dumps(gen_launches)}); logits of "
        f"{n_replays} replayed steps bitwise the eager steps' {bitwise}")
    log(f"  walls (s): decode step eager {eager_s:.5f} (mean of "
        f"{len(eager_w) - 1} after the first), replayed {replay_s:.5f} "
        f"(mean of {n_replays}), {eager_s / replay_s:.2f}x; capture "
        f"{cap_s:.4f}")
    busy = device_breakdown(graph.replay, "replayed decode step")
    if busy is not None:
        # the profiler's host cost lengthens the wall it sees; against the
        # unprofiled replay wall
        log(f"  replayed decode step: device busy {busy:.2f} ms of the "
            f"unprofiled {replay_s * 1e3:.2f} ms, idle share "
            f"{1 - busy / (replay_s * 1e3):.3f}")
    del graph, loop, got_lg, eager_lg
    check(same_tok and same_counts and bitwise,
          "generate's decode through the graph against the eager loop")


def phase_main_path() -> dict:
    """opt-proxy served with the bf16 cache."""
    import torch
    from repro_torch.models import transformer as T

    r = drive_main_path("opt-proxy", "fp16", 4, 16, 16)
    launches, res = r["launches"], r["res"]
    for name in ("hessian_accum", "gptq_block", "rpiq_block",
                 "w4a16_matmul", "quant_pack"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")

    mc = r["cfg"].model
    toks = r["calib"][-1]["tokens"].cuda()
    lq = T.forward(mc, r["packed"], toks)
    lf = T.forward(mc, r["params_q"], toks)
    rel = float((lq - lf).norm() / (lf.norm() + 1e-9))
    ok_shape = tuple(res.tokens.shape) == (4, 16)
    finite = bool(torch.isfinite(lq).all())
    log(f"  packed int4 vs refined-grid float logits: rel err {rel:.5f} "
        f"(tol 2e-2); finite {finite}")
    log(f"  decoded tokens: {res.tokens.tolist()} steps "
        f"{res.steps.tolist()}")
    check(rel < 2e-2 and finite and ok_shape, "main path output check")
    return launches


def phase_int8_kv_path() -> dict:
    """internlm2-1.8b served with the int8 KV cache: the cache bytes, the
    launch counts, the packed-vs-float logits, the int8-vs-bf16 cache
    drift and quant_pack against the packed artifact."""
    import torch
    from repro_torch.core.quant import quantized_leaves
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    n_req, n_prompt, n_new = 4, 512, 32
    r = drive_main_path("internlm2-1.8b", "int8", n_req, n_prompt, n_new)
    cfg, params_q, packed = r["cfg"], r["params_q"], r["packed"]
    launches, res, prompt = r["launches"], r["res"], r["prompt"]
    mc, qc = cfg.model, cfg.quant
    max_len = n_prompt + n_new + 1
    cache_bytes = {
        kind: mc.num_layers * sum(
            t.numel() * t.element_size() for t in T.init_layer_cache(
                mc, ("attn", "dense"), n_req, max_len, "cuda", dt).values())
        for kind, dt in (("int8", "int8"), ("bf16", torch.bfloat16))}
    log(f"  KV cache bytes at {n_req} x {max_len} slots: int8 (codes + "
        f"scales + error accumulators) {cache_bytes['int8']} vs bf16 "
        f"{cache_bytes['bf16']} "
        f"({cache_bytes['bf16'] / cache_bytes['int8']:.2f}x)")
    for name, n in launches.items():
        if name == "selective_scan":    # a Mamba kernel: none here
            check(n == 0, "selective_scan launched on the int8-KV path")
        else:
            check(n > 0, f"kernel {name} was not launched on the int8-KV "
                  "path")
    decode_calls = mc.num_layers * (n_new - 1)
    check(launches["int8_kv_attention"] == decode_calls,
          f"int8_kv_attention launched {launches['int8_kv_attention']} "
          f"times, expected {decode_calls} (layers x decode steps)")

    # packed int4 against the refined grid: in fp32 compute both models
    # hold the same weights and differ only in summation order; in bf16 the
    # float model also rounds its weights to bf16 before each product (the
    # packed one dequantizes exactly), which 24 layers carry to ~2e-2
    toks = r["calib"][-1]["tokens"].cuda()
    rel = {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        lq = T.forward(mdt, packed, toks)
        lf = T.forward(mdt, params_q, toks)
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        if dt == "bfloat16":
            finite = bool(torch.isfinite(lq).all())
        del lq, lf
    log(f"  packed int4 vs refined-grid float logits: fp32 compute rel err "
        f"{rel['float32']:.3e} (tol 1e-3); bf16 compute {rel['bfloat16']:.5f}"
        f" (not pinned: the float model's bf16 weight rounding); finite "
        f"{finite}")
    log(f"  decoded tokens (request 0): {res.tokens[0].tolist()} steps "
        f"{res.steps.tolist()}")
    check(rel["float32"] < 1e-3 and finite
          and tuple(res.tokens.shape) == (n_req, n_new),
          "int8-KV path output check")

    # drift: the int8 and the bf16 cache fed the same (bf16-chosen) stream
    ptoks = prompt["tokens"].cuda()

    def timed_prefill(dt):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = T.prefill(mc, packed, ptoks, n_prompt + 17, cache_dtype=dt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    caches, walls = {}, {}
    (lg, caches["bf16"]), walls["prefill bf16"] = timed_prefill(
        torch.bfloat16)
    (_, caches["int8"]), walls["prefill int8"] = timed_prefill("int8")
    tok = torch.argmax(lg, -1)
    pos = torch.full((n_req,), n_prompt, dtype=torch.long, device="cuda")
    deltas, scale = [], 0.0
    step = {"bf16": 0.0, "int8": 0.0}
    for _ in range(16):
        out = {}
        for kind in ("bf16", "int8"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[kind], caches[kind] = T.decode_step(mc, packed, tok, pos,
                                                    caches[kind])
            torch.cuda.synchronize()
            step[kind] += (time.perf_counter() - t) / 16
        deltas.append(float((out["bf16"] - out["int8"]).abs().max()))
        scale = max(scale, float(out["bf16"].abs().max()))
        tok = torch.argmax(out["bf16"], -1)
        pos = pos + 1
    early, late = max(deltas[:8]), max(deltas[8:])
    log(f"  walls (s): prefill bf16 cache {walls['prefill bf16']:.3f}, "
        f"int8 cache {walls['prefill int8']:.3f}; decode step bf16 cache "
        f"{step['bf16']:.4f}, int8 cache {step['int8']:.4f} (mean of 16)")
    log(f"  drift int8 vs bf16 cache over 16 steps: max |dlogit| per step "
        f"{[round(d, 4) for d in deltas]}; max {max(deltas):.4f} = "
        f"{max(deltas) / scale:.3e} of max |logit| {scale:.3f}; late "
        f"{late:.4f} <= 3 x early {early:.4f} + 0.05: "
        f"{late <= 3 * early + 0.05}")
    check(late <= 3 * early + 0.05, "int8 KV drift does not accumulate")
    del caches

    # quant_pack against the path's packed artifact, every quantized linear
    n_lin = n_eq = 0
    for path, packed_w in quantized_leaves(packed["layers"]):
        lin = resolve(params_q["layers"], path.rsplit(".", 1)[0])
        w_oi = lin["w"].float().T.contiguous()
        art = packed_w.packed
        kern = ops.quant_pack(w_oi, lin["qscales"], lin["qzeros"],
                              group_size=qc.group_size)
        plain = ref.quant_pack(w_oi, lin["qscales"], lin["qzeros"],
                               qc.group_size)
        n_lin += 1
        n_eq += int(torch.equal(kern, art) and torch.equal(plain, art))
    n_quantized = sum(1 for rec in r["report"].linears
                      if rec.mode != "skipped")
    log(f"  quant_pack (kernel and plain version) bitwise equal to the "
        f"packed artifact: {n_eq} of {n_lin} packed linears ({n_quantized} "
        f"quantized)")
    check(n_eq == n_lin == n_quantized,
          "quant_pack against the packed artifact")
    return launches


def device_breakdown(fn, label: str, top: int = 6) -> None:
    """Run fn once under torch.profiler; print its wall (with the
    profiler's own host cost in it), its kernels' device time (their sum:
    one stream, no overlap), the idle share and the kernels that take the
    most device time; returns the device time in ms (None if the profiler
    recorded no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    if not kern:
        log(f"  {label}: wall {wall_ms:.1f} ms; device time not measured "
            "(the profiler recorded no kernel)")
        return None
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    tops = "; ".join(
        f"{e.key.replace('(anonymous namespace)::', '')[:48]} x{e.count} "
        f"{e.self_device_time_total / 1e3:.1f} ms" for e in kern[:top])
    log(f"  {label} (torch.profiler): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; top "
        f"kernels: {tops}")
    return busy_ms


@contextlib.contextmanager
def paired_route(readings: list, kernel_inputs=None):
    """The model code's calls of ``ops.w4a16_matmul`` and
    ``ops.selective_scan`` run the kernel and, on the same inputs, the
    plain version; each call appends (op, reading) to ``readings`` and the
    path goes on with the kernel's output. The reading is phase 3's: for a
    bf16 output ``bf16_ulps``, for fp32 the largest |kernel - plain| over
    the largest |plain|. ``kernel_inputs`` maps id(packed weight) to a
    faulty (packed, zeros) pair handed to the kernel only: the control."""
    import torch
    from repro_torch.kernels import ops, ref
    saved = ops.w4a16_matmul, ops.selective_scan
    swap = kernel_inputs or {}

    def reading(got, want):
        diff = got.float() - want.float()
        if want.dtype == torch.bfloat16:
            return bf16_ulps(diff, want)
        return float(diff.abs().max() / want.abs().max())

    def w4a16(x, packed, scales, zeros, *, group_size=128):
        want = ref.w4a16_matmul(x.reshape(-1, x.shape[-1]), packed, scales,
                                zeros, group_size)
        pk, zs = swap.get(id(packed), (packed, zeros))
        got = saved[0](x, pk, scales, zs, group_size=group_size)
        readings.append(("w4a16_matmul",
                         reading(got.reshape(want.shape), want)))
        return got

    def scan(*args):
        want, _ = ref.selective_scan(*args)
        got = saved[1](*args)
        readings.append(("selective_scan", reading(got[0], want)))
        return got

    ops.w4a16_matmul, ops.selective_scan = w4a16, scan
    try:
        yield
    finally:
        ops.w4a16_matmul, ops.selective_scan = saved


def phase_mamba_path() -> dict:
    """falcon-mamba-7b at full width and depth: the launch counts (the
    scan once per layer and calibration batch in capture and in
    propagate, once per layer at prefill; no KV attention), the walls,
    bytes and the recurrent state against a bf16 KV cache of the same
    depth; then in fp32 compute the packed-vs-float logits and the
    prefill → decode hand-off; the first layers' kernels against their
    plain versions in fp32 and bf16, each beside a control with a fault;
    generate's tokens against the timed prefill and decode steps."""
    import torch
    from repro_torch.models import transformer as T

    n_req, n_prompt, n_new = 4, 512, 32
    r = drive_main_path("falcon-mamba-7b", "fp16", n_req, n_prompt, n_new)
    cfg, params_q, packed = r["cfg"], r["params_q"], r["packed"]
    launches, res, prompt = r["launches"], r["res"], r["prompt"]
    mc = cfg.model
    for name, k in launches.items():
        if name == "int8_kv_attention":
            check(k == 0, "int8_kv_attention launched on the Mamba path")
        else:
            check(k > 0, f"kernel {name} was not launched on the Mamba path")
    scans = mc.num_layers * (2 * len(r["calib"]) + 1)
    check(launches["selective_scan"] == scans,
          f"selective_scan launched {launches['selective_scan']} times, "
          f"expected {scans} (layers x (capture + propagate batches + "
          "prefill))")
    n_skipped = sum(1 for rec in r["report"].linears
                    if rec.mode == "skipped")
    check(n_skipped == 0, f"{n_skipped} linears skipped at full width")

    max_len = n_prompt + n_new + 1
    state = mc.num_layers * sum(
        t.numel() * t.element_size() for t in T.init_layer_cache(
            mc, ("mamba", "none"), n_req, max_len, "cuda",
            torch.bfloat16).values())
    # K and V, d_model wide per slot: an attention stack of the same width
    kv = 2 * mc.num_layers * n_req * max_len * mc.d_model * 2
    log(f"  recurrent state bytes ({n_req} requests, bf16, any length): "
        f"{state}; a bf16 KV cache of the same depth and width at "
        f"{max_len} slots: {kv} ({kv / state:.1f}x, growing with the "
        f"context)")

    ptoks = prompt["tokens"].cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, caches = T.prefill(mc, packed, ptoks, max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    tok = torch.argmax(lg, -1)
    greedy = [tok]
    pos = torch.full((n_req,), n_prompt, dtype=torch.long, device="cuda")
    n_steps = 8
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        lg, caches = T.decode_step(mc, packed, tok, pos, caches)
        tok = torch.argmax(lg, -1)
        greedy.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / n_steps
    state_dt = {str(c[k].dtype) for c in caches for k in c}
    log(f"  walls (s): prefill {prefill_s:.3f}; decode step {step_s:.4f} "
        f"(mean of {n_steps}); state dtypes after decode {state_dt}")
    check(state_dt == {"torch.bfloat16"}, "the state stays in bf16")
    device_breakdown(lambda: T.prefill(mc, packed, ptoks, max_len),
                     "prefill")
    device_breakdown(lambda: T.decode_step(mc, packed, tok, pos, caches),
                     "decode step")
    del caches, lg

    # (a) packed int4 against the refined grid; in fp32 compute both models
    # hold the same weights and differ only in summation order
    toks = r["calib"][-1]["tokens"].cuda()
    m32 = dataclasses.replace(mc, dtype="float32")
    rel = {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        lq = T.forward(mdt, packed, toks)
        lf = T.forward(mdt, params_q, toks)
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        if dt == "bfloat16":
            finite = bool(torch.isfinite(lq).all())
        else:
            lf32 = lf
        del lq, lf
    # how far the float model itself carries a perturbation the size of
    # fp32 rounding: every embedding value moved by a relative 1e-6
    emb = params_q["embed"]["embedding"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    noisy = dict(params_q, embed={"embedding": emb * (1 + 1e-6 * torch.randn(
        emb.shape, generator=gen, device="cuda"))})
    ln = T.forward(m32, noisy, toks)
    sens = float((ln - lf32).norm() / lf32.norm())
    del noisy, ln, lf32
    log(f"  packed int4 vs refined-grid float logits: fp32 compute rel err "
        f"{rel['float32']:.3e} (tol 1e-3); bf16 compute {rel['bfloat16']:.5f}"
        f" (not pinned); finite {finite}; the float model's fp32 logits "
        f"move by {sens:.3e} rel when each embedding value moves by a "
        f"relative 1e-6")

    # (b) the prefill -> decode hand-off: the kernel's h_last and the conv
    # inputs feed the plain decode recurrence. In fp32 the two differ in
    # the order of a few sums per layer (the decode's b = (dt*B)*u against
    # the scan's (dt*u)*B, and y's sum over the states), over 64 layers
    full = T.forward(m32, packed, ptoks)[:, -1]
    _, caches = T.prefill(m32, packed, ptoks[:, :-1], n_prompt)
    last = torch.full((n_req,), n_prompt - 1, dtype=torch.long,
                      device="cuda")
    stepped, _ = T.decode_step(m32, packed, ptoks[:, -1], last, caches)
    rel_b = float((stepped - full).norm() / full.norm())
    same_top = bool(torch.equal(stepped.argmax(-1), full.argmax(-1)))
    log(f"  prefill of {n_prompt - 1} tokens + 1 decode step vs the full "
        f"forward over {n_prompt}, last-position logits in fp32 compute: "
        f"rel err {rel_b:.3e} (tol 1e-4); same argmax {same_top}")
    del full, caches, stepped

    # (c) the first layers at full width, in fp32 and in bf16 (the
    # serving dtype): every kernel call against its plain version on the
    # same inputs, at phase 3's pins, a check that rides on no depth's
    # gain. The control hands layer 0's kernel a fault: one int4 code one
    # grid step off in the out projection, or one group's zero point one
    # off in the in projection
    n_cmp = 4
    mixer0 = packed["layers"][0]["mixer"]

    def fault(name, code):
        qt = mixer0[name]["w"]
        pk, zs = qt.packed.clone(), qt.zeros.clone()
        if code:
            lo = pk[0, 0] & 0x0F
            pk[0, 0] = (pk[0, 0] & 0xF0) | (lo + 1 if lo < 15 else lo - 1)
        else:
            zs[0, 0] += 1.0 if zs[0, 0] < 15 else -1.0
        return {id(qt.packed): (pk, zs)}

    controls = {"one code (out)": fault("out", True),
                "one group's zero (in)": fault("in", False)}
    pins = {"float32": 1e-5, "bfloat16": 1.0}
    positions = T.positions_for(n_req, n_prompt, "cuda")
    layers_ok = True
    for dt, pin in pins.items():
        mdt = dataclasses.replace(mc, dtype=dt)
        h = T.embed(packed["embed"], ptoks, T.compute_dtype(mdt))
        calls = []
        with paired_route(calls):
            for spec, p in zip(T.layer_specs(mdt)[:n_cmp],
                               packed["layers"][:n_cmp]):
                h = T.layer_forward(mdt, spec, p, h, positions)
        sound = {op: max(v for o, v in calls if o == op)
                 for op in ("w4a16_matmul", "selective_scan")}
        ctrl = {}
        for k, swap in controls.items():
            h = T.embed(packed["embed"], ptoks, T.compute_dtype(mdt))
            bad = []
            with paired_route(bad, swap):
                T.layer_forward(mdt, T.layer_specs(mdt)[0],
                                packed["layers"][0], h, positions)
            ctrl[k] = max(v for _, v in bad)
        del h
        unit = "bf16 ulps" if dt == "bfloat16" else "of the largest output"
        log(f"  {dt}, layers 0-{n_cmp - 1}: {len(calls)} kernel calls "
            f"against their plain versions on the same inputs, largest "
            f"difference ({unit}): "
            f"{ {k: f'{v:.3g}' for k, v in sound.items()} } (tol {pin:g}); "
            f"control, layer 0 with a fault on the kernel's inputs: "
            f"{ {k: f'{v:.3g}' for k, v in ctrl.items()} }")
        layers_ok = layers_ok and (max(sound.values()) <= pin
                                   < min(ctrl.values()))

    # (d) generate's greedy tokens are the timed prefill's and decode
    # steps' argmax (the same bf16 route, deterministic kernels)
    same_gen = bool(torch.equal(res.tokens[:, :n_steps + 1].cuda(),
                                torch.stack(greedy, dim=1)))
    log(f"  generate's first {n_steps + 1} tokens equal the timed prefill "
        f"and decode steps' argmax: {same_gen}")
    log(f"  decoded tokens (request 0): {res.tokens[0].tolist()} steps "
        f"{res.steps.tolist()}")
    check(rel["float32"] < 1e-3 and finite and rel_b <= 1e-4 and layers_ok
          and same_gen and tuple(res.tokens.shape) == (n_req, n_new),
          "Mamba path output check")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError:
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("[1] device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind} x{count}")
    log(f"  nvidia-smi: {smi}")

    log("[2] build")
    t = time.perf_counter()
    out = build.build_all()
    log(f"  built into {os.path.relpath(out, ROOT)} in "
        f"{time.perf_counter() - t:.1f}s")
    for name, lines in build.ptxas_report().items():
        for ln in lines.splitlines():
            log(f"  {name}: {ln}")

    log("[3] kernels against their plain versions (card)")
    table = KernelTable()
    phase_kernels(table)
    from repro_torch.kernels import ops
    log(f"  launches in this phase (checks and timing): "
        f"{json.dumps(ops.kernel_launches())}")

    log("[4] small end to end: smoke configs, card against CPU plain (fp32),"
        " then at their own bf16 and group size on the card")
    phase_small_end_to_end("opt-proxy", "fp16")
    phase_small_end_to_end("internlm2-1.8b", "int8")
    phase_small_end_to_end("falcon-mamba-7b", "fp16")
    phase_small_bf16("opt-proxy", "fp16")
    phase_small_bf16("internlm2-1.8b", "int8")
    phase_small_bf16("falcon-mamba-7b", "fp16")

    log("[5] main path at full width: opt-proxy")
    launches = phase_main_path()

    log("[6] main path at full width: internlm2-1.8b, int8 KV cache")
    for name, n in phase_int8_kv_path().items():
        launches[name] += n

    log("[7] main path at full width: falcon-mamba-7b (Mamba-1)")
    for name, n in phase_mamba_path().items():
        launches[name] += n

    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(table.json(launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
