#!/usr/bin/env python3
"""Time rpiq_block and the w4a16_matmul wrapper of one checkout on the card.

    python3 chip_compare.py <checkout root>

Run it on two checkouts in turns inside one call on one card (parent,
change, change, parent; the parent unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) to compare them. It prints, per
line: the checkout, the kernel and shape, and

- for ``rpiq_block`` at the main path's three groups (n 512, t_max 5):
  the mean CUDA-event time of one launch and the sums of its five outputs
  (equal sums across checkouts show equal results);
- for ``w4a16_matmul`` at decode (m 4): the mean time per call of a loop
  of wrapper calls, which the host's per-call cost sets at this size;
- where the checkout has them, ``int8_kv_attention`` (bf16 queries at
  internlm2's decode shape, S 545 and 4096) and ``quant_pack`` (fp32,
  internlm2's widest linears): the device time per call from a CUDA graph
  over copies beyond L2 (``chip_smoke.graph_ms``), the error against the
  plain version and an output sum.
"""
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import hessian as hess
    from repro_torch.core.quant import (compute_qparams, pack_int4,
                                        quantize_codes)
    from repro_torch.core.rpiq import _block_curvature_inv
    from repro_torch.kernels import build, ops

    build.build_all()
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n_tok, gs, bs, t_max = 512, 128, 128, 5

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    for b, o, i in ((4, 768, 768), (1, 3072, 768), (1, 768, 3072)):
        x = torch.randn((b, n_tok, i), generator=g, device=dev)
        w = torch.randn((b, o, i), generator=g, device=dev) * i ** -0.5
        count = torch.full((b,), n_tok, dtype=torch.int32, device=dev)
        hd = hess.damped(hess.HessianState(x.transpose(1, 2) @ x, count),
                         torch.full((b,), 0.01, device=dev))
        u = hess.cholesky_inverse_upper(hd)
        w0, sc, zr, _ = ops.gptq_block_cuda(w, u, bits=4, group_size=gs,
                                            blocksize=bs, symmetric=False)
        hinv = _block_curvature_inv(x, hd, count, count, block_size=bs,
                                    exact_gram=False).reshape(b, i, bs)
        args = (w0, x @ w.transpose(1, 2), x, hinv,
                sc.repeat_interleave(gs, -1), zr.repeat_interleave(gs, -1))
        kw = dict(bits=4, block_size=bs, alpha=0.01, t_max=t_max,
                  symmetric=False)
        sums = [float(t.double().sum())
                for t in ops.rpiq_block_cuda(*args, **kw)]
        ms = event_ms(lambda: ops.rpiq_block_cuda(*args, **kw), 5)
        print(f"{root} rpiq_block {b}x{o}x{i}: ms={ms:.4f} sums={sums}",
              flush=True)

    for k, n in ((768, 768), (3072, 768)):
        w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        qp = compute_qparams(w, 4, gs)
        packed = pack_int4(quantize_codes(w, qp, 4, gs))
        x = torch.randn((4, k), generator=g, device=dev).to(torch.bfloat16)
        ms = event_ms(lambda: ops.w4a16_matmul_cuda(
            x, packed, qp.scales, qp.zeros, gs), 500)
        print(f"{root} w4a16_matmul m=4 k={k} n={n}: ms per wrapper call "
              f"(host-bound loop) {ms:.5f}", flush=True)

    from chip_smoke import graph_ms
    from repro_torch.kernels import ref
    if hasattr(ops, "int8_kv_attention_cuda"):
        b, kv, r, hd = 4, 8, 2, 128
        for s, blk in ((545, 128), (4096, 128), (4096, 64)):
            codes = torch.randint(-127, 128, (2, b, s, kv, hd), generator=g,
                                  device=dev).to(torch.int8)
            scales = torch.rand((2, b, s, kv, hd // blk), generator=g,
                                device=dev) * 0.02 + 1e-3
            kpos = torch.arange(s, device=dev, dtype=torch.int32).repeat(
                b, 1)
            cache = (codes[0], scales[0], codes[1], scales[1], kpos)
            q = (torch.randn((b, kv, r, hd), generator=g, device=dev)
                 * hd ** -0.5).to(torch.bfloat16)
            out = ops.int8_kv_attention_cuda(q, *cache, blk).float()
            err = float((out - ref.int8_kv_attention(q, *cache, blk).float())
                        .abs().max())
            nbytes = sum(t.numel() * t.element_size() for t in cache)
            copies = [cache] + [tuple(t.clone() for t in cache)
                                for _ in range(int(100e6 // nbytes))]
            ms = graph_ms([(lambda c=c: ops.int8_kv_attention_cuda(
                q, *c, blk)) for c in copies])
            print(f"{root} int8_kv_attention S={s} kv_block={blk}: "
                  f"ms={ms:.4f} max_abs_err={err:.3e} "
                  f"sum={float(out.double().sum())}", flush=True)
    if hasattr(ops, "quant_pack_cuda"):
        for n, k in ((2048, 8192), (8192, 2048)):
            w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
            qp = compute_qparams(w, 4, gs)
            args = (w, qp.scales, qp.zeros)
            same = torch.equal(ops.quant_pack_cuda(*args, gs),
                               ref.quant_pack(*args, gs))
            copies = [args] + [tuple(t.clone() for t in args)]
            ms = graph_ms([(lambda c=c: ops.quant_pack_cuda(*c, gs))
                           for c in copies])
            print(f"{root} quant_pack n={n} k={k}: ms={ms:.4f} "
                  f"bitwise equal to the plain version {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
