#!/usr/bin/env python3
"""Time the kernels of one checkout on the card, for parent-vs-change runs.

    python3 chip_compare.py <checkout root>

Run it on two checkouts in turns inside one call on one card (parent,
change, change, parent; the parent unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) to compare them. It prints, per
line: the checkout, the kernel and shape, and

- for ``hessian_accum`` at the six d of the three main paths (n 512): the
  device time per call from a CUDA graph (as ``chip_smoke.py`` phase 3),
  ``x.T @ x``'s beside it, the error against the plain version and the
  sum of H; where the checkout picks a cluster size
  (``ops.hessian_accum_geometry``), the size and the time of every other
  one, the sweep that rule rests on;
- for ``gptq_block`` and ``rpiq_block`` at the main paths' eleven groups
  (opt-proxy's three, internlm2-1.8b's four, falcon-mamba-7b's four; n
  512, t_max 5): the mean CUDA-event time of one launch; for
  ``gptq_block`` an exact checksum of each of its four outputs (w_q,
  scales, zeros, the per-row sum of err^2: the int32 view of the fp32
  bits summed as int64, equal across checkouts only where the outputs
  are bitwise equal, barring a coincidence), for ``rpiq_block`` exact
  checksums of w_cont, the candidates and Y_q and the sums of Gamma and
  the projected loss;
- for ``w4a16_matmul`` with bf16 x at every phase-3 (m, k, n) of
  ``chip_smoke.py`` (group 128): the device time per call from a CUDA
  graph over weight copies beyond L2, the error in bf16 ulps against the
  plain version, an exact checksum of the output's bits (equal across
  checkouts where the outputs are bitwise equal), the library's
  ``_weight_int4pack_mm`` beside it (``chip_smoke.int4pack_yardstick``),
  and, where the checkout splits k, the splits and whether two launches
  are bitwise equal; then at decode (m 4) the mean time per call of a loop
  of wrapper calls, which the host's per-call cost sets at this size, and
  the host's time to enqueue a call (the median and quartiles of 21
  rounds of 200 calls on the host clock, the card left to catch up
  between rounds);
- where the checkout has them, ``int8_kv_attention`` (bf16 queries at
  internlm2's decode shape, S 545 and 4096) and ``quant_pack`` (the six
  main-path shapes, weights in fp32 and bf16): the device time per call
  from a CUDA graph over copies beyond L2 (``chip_smoke.graph_ms``), the
  error against the plain version (bitwise for ``quant_pack``) and an
  output sum; for ``int8_kv_attention`` also the
  checkout's history ranges (``ops.int8_kv_attention_geometry``, 1 where
  it has none), whether two launches are bitwise equal, at S 545 the mean
  time per call of a loop of wrapper calls and the host's own time to
  enqueue a call (as for ``w4a16_matmul`` at m 4), and, where the
  checkout has the geometry, the time at every range length of 1 to 8
  tiles, the sweep that rule rests on;
- ``selective_scan`` at falcon-mamba-7b's shapes (B 4, d 8192, n 16) at
  S 512, 128 and 77, u in fp32 and bf16: the device time per call from a
  CUDA graph over input copies beyond L2, an exact checksum of h_last's
  bits and y's error against the plain version (relative to the largest
  output in fp32, bf16 ulps in bf16);
- the decode step wall of each main path at full width (``decode_walls``).
"""
import os
import sys
import time


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

    def host_ms(fn, calls=200, rounds=21):
        """The host's time to enqueue one call, as 'median (quartiles)' in
        ms: rounds of `calls` calls timed on the host clock without waiting
        for the card (the queue takes them all), one synchronize between
        rounds, after 50 calls of warm-up."""
        for _ in range(50):
            fn()
        per = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
        per.sort()
        return (f"{per[rounds // 2]:.5f} ({per[rounds // 4]:.5f}, "
                f"{per[3 * rounds // 4]:.5f})")

    from repro_torch.kernels import ref
    from chip_smoke import bf16_ulps, graph_ms, int4pack_yardstick

    def bits(t):
        """Exact checksum of an fp32 or bf16 tensor's bits."""
        itype = torch.int32 if t.dtype == torch.float32 else torch.int16
        return int(t.contiguous().view(itype).to(torch.int64).sum())

    for d in (256, 768, 2048, 3072, 4096, 8192):
        x = torch.randn((n_tok, d), generator=g, device=dev)
        H0 = torch.randn((d, d), generator=g, device=dev)
        H0 = H0 + H0.T
        want = ref.hessian_accum(x, H0)
        got = ops.hessian_accum_cuda(x, H0.clone())
        err = float((got - want).abs().max() / want.abs().max())
        Hk = H0.clone()
        ms = graph_ms([lambda: ops.hessian_accum_cuda(x, Hk)])
        lms = graph_ms([lambda: x.T @ x])
        line = (f"{root} hessian_accum n={n_tok} d={d}: ms={ms:.4f} "
                f"library_ms(x.T@x)={lms:.4f} rel_err={err:.2e} "
                f"sum={float(got.double().sum())}")
        if hasattr(ops, "hessian_accum_geometry"):
            lib = build.load("hessian_accum")
            sweep = [(split, graph_ms([
                lambda: lib.hessian_accum_launch(
                    x.data_ptr(), Hk.data_ptr(), n_tok, d, split,
                    torch.cuda.current_stream().cuda_stream)]))
                for split in (1, 2, 4, 8)]
            line += (f" split={ops.hessian_accum_geometry(n_tok, d)} "
                     "sweep (split, ms): "
                     + " ".join(f"({s_},{m:.4f})" for s_, m in sweep))
        print(line, flush=True)

    for b, o, i in ((4, 768, 768), (1, 3072, 768), (1, 768, 3072),
                    (1, 2048, 2048), (2, 1024, 2048), (2, 8192, 2048),
                    (1, 2048, 8192), (1, 16384, 4096), (1, 288, 8192),
                    (1, 8192, 256), (1, 4096, 8192)):
        x = torch.randn((b, n_tok, i), generator=g, device=dev)
        w = torch.randn((b, o, i), generator=g, device=dev) * i ** -0.5
        count = torch.full((b,), n_tok, dtype=torch.int32, device=dev)
        hd = hess.damped(hess.HessianState(x.transpose(1, 2) @ x, count),
                         torch.full((b,), 0.01, device=dev))
        u = hess.cholesky_inverse_upper(hd)
        gkw = dict(bits=4, group_size=gs, blocksize=bs, symmetric=False)
        outs = ops.gptq_block_cuda(w, u, **gkw)
        ms = event_ms(lambda: ops.gptq_block_cuda(w, u, **gkw), 3)
        print(f"{root} gptq_block {b}x{o}x{i}: ms={ms:.4f} bit checksums "
              f"(w_q, scales, zeros, err_rows)={[bits(t) for t in outs]}",
              flush=True)
        w0, sc, zr, _ = outs
        hinv = _block_curvature_inv(x, hd, count, count, block_size=bs,
                                    exact_gram=False).reshape(b, i, bs)
        args = (w0, x @ w.transpose(1, 2), x, hinv,
                sc.repeat_interleave(gs, -1), zr.repeat_interleave(gs, -1))
        kw = dict(bits=4, block_size=bs, alpha=0.01, t_max=t_max,
                  symmetric=False)
        outs = ops.rpiq_block_cuda(*args, **kw)
        sums = [float(t.double().sum()) for t in outs[3:]]
        ms = event_ms(lambda: ops.rpiq_block_cuda(*args, **kw), 5)
        print(f"{root} rpiq_block {b}x{o}x{i}: ms={ms:.4f} bit checksums "
              f"(w_cont, candidates, Y_q)={[bits(t) for t in outs[:3]]} "
              f"sums (Gamma, proj-loss)={sums}", flush=True)

    cases = [(m, k, n) for m in (4, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases += [(m, k, n) for m in (4, 2048)
              for k, n in ((2048, 2048), (2048, 1024), (2048, 8192),
                           (8192, 2048), (4096, 16384), (8192, 288),
                           (256, 8192), (8192, 4096))]
    for m, k, n in cases:
        w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        qp = compute_qparams(w, 4, gs)
        packed = pack_int4(quantize_codes(w, qp, 4, gs))
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        args = (packed, qp.scales, qp.zeros)
        want = ref.w4a16_matmul(x, *args, gs)
        got = ops.w4a16_matmul_cuda(x, *args, gs)
        ulps = bf16_ulps(got.float() - want.float(), want)
        nbytes = n * k / 2 + 2 * n * (k / gs) * 4 + 2 * m * k + 2 * m * n
        copies = [args] + [tuple(t.clone() for t in args)
                           for _ in range(min(255, int(100e6 // nbytes)))]
        ms = graph_ms([(lambda c=c: ops.w4a16_matmul_cuda(x, *c, gs))
                       for c in copies])
        del copies
        lms, _ = int4pack_yardstick(x, *args, gs, want, nbytes)
        line = (f"{root} w4a16_matmul bf16 m={m} k={k} n={n}: ms={ms:.4f} "
                f"library_ms(_weight_int4pack_mm)={lms:.4f} "
                f"bf16_ulps={ulps:.3g} bit checksum={bits(got)}")
        if hasattr(ops, "w4a16_matmul_geometry"):
            splits = ops.w4a16_matmul_geometry(m, n, k, gs)[2]
            line += (f" splits={splits} two launches bitwise equal "
                     f"{torch.equal(got, ops.w4a16_matmul_cuda(x, *args, gs))}")
        print(line, flush=True)

    for k, n in ((768, 768), (3072, 768)):
        w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        qp = compute_qparams(w, 4, gs)
        packed = pack_int4(quantize_codes(w, qp, 4, gs))
        x = torch.randn((4, k), generator=g, device=dev).to(torch.bfloat16)
        call = (lambda: ops.w4a16_matmul_cuda(x, packed, qp.scales,
                                              qp.zeros, gs))
        ms = event_ms(call, 500)
        print(f"{root} w4a16_matmul m=4 k={k} n={n}: ms per wrapper call "
              f"(host-bound loop) {ms:.5f}, host enqueue ms per call "
              f"{host_ms(call)}", flush=True)

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
            out = ops.int8_kv_attention_cuda(q, *cache, blk)
            same = torch.equal(out, ops.int8_kv_attention_cuda(q, *cache,
                                                               blk))
            out = out.float()
            err = float((out - ref.int8_kv_attention(q, *cache, blk).float())
                        .abs().max())
            splits = (ops.int8_kv_attention_geometry(b, kv, s)[0]
                      if hasattr(ops, "int8_kv_attention_geometry") else 1)
            nbytes = sum(t.numel() * t.element_size() for t in cache)
            copies = [cache] + [tuple(t.clone() for t in cache)
                                for _ in range(int(100e6 // nbytes))]
            ms = graph_ms([(lambda c=c: ops.int8_kv_attention_cuda(
                q, *c, blk)) for c in copies])
            sweep = ""
            if hasattr(ops, "int8_kv_attention_geometry") and blk == 128:
                # every range length, the sweep the geometry rests on
                lib = build.load("int8_kv_attention")
                tiles = -(-s // ops.KV_TILE)
                times = []
                for per in (1, 2, 3, 4, 6, 8):
                    if per > tiles:
                        continue
                    n_sp = -(-tiles // per)
                    tk, wk = ops._kv_workspace(
                        q, b * kv, b * kv * n_sp * (r * hd + 2 * r))

                    def launch(c, n_sp=n_sp, per=per, tk=tk, wk=wk):
                        o = torch.empty_like(q)
                        err = lib.int8_kv_attention_bf16_launch(
                            q.data_ptr(), *(t.data_ptr() for t in c),
                            o.data_ptr(), b, s, kv, r, hd, blk, n_sp, per,
                            wk, tk, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"launch failed: {err}")
                    times.append((per, n_sp, graph_ms(
                        [(lambda c=c: launch(c)) for c in copies])))
                sweep = " sweep (tiles a range, ranges, ms): " + " ".join(
                    f"({p_},{n_},{t_:.4f})" for p_, n_, t_ in times)
            del copies
            host = ""
            if s == 545:
                call = (lambda: ops.int8_kv_attention_cuda(q, *cache, blk))
                host = (f" ms per wrapper call (host-bound loop) "
                        f"{event_ms(call, 500):.5f}, host enqueue ms per "
                        f"call {host_ms(call)}")
            print(f"{root} int8_kv_attention S={s} kv_block={blk}: "
                  f"ms={ms:.4f} max_abs_err={err:.3e} "
                  f"sum={float(out.double().sum())} history ranges={splits} "
                  f"two launches bitwise equal {same}{host}{sweep}",
                  flush=True)
    if hasattr(ops, "quant_pack_cuda"):
        for n, k in ((2048, 8192), (8192, 2048), (16384, 4096), (288, 8192),
                     (8192, 256), (4096, 8192)):
            w32 = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
            qp = compute_qparams(w32, 4, gs)
            for wdt in (torch.float32, torch.bfloat16):
                args = (w32.to(wdt), qp.scales, qp.zeros)
                out = ops.quant_pack_cuda(*args, gs)
                same = torch.equal(out, ref.quant_pack(*args, gs))
                nbytes = sum(t.numel() * t.element_size() for t in args)
                copies = [args] + [tuple(t.clone() for t in args) for _ in
                                   range(min(63, int(100e6 // nbytes)))]
                ms = graph_ms([(lambda c=c: ops.quant_pack_cuda(*c, gs))
                               for c in copies])
                del copies
                print(f"{root} quant_pack n={n} k={k} w={wdt}: ms={ms:.4f} "
                      f"bitwise equal to the plain version {same} "
                      f"output sum={int(out.to(torch.int64).sum())}",
                      flush=True)

    import torch.nn.functional as F
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
        for udt in (torch.float32, torch.bfloat16):
            args = (u.to(udt),) + rest
            y, h_last = ops.selective_scan_cuda(*args)
            y_want, _ = ref.selective_scan(*args)
            diff = y.float() - y_want.float()
            if udt == torch.float32:
                rel = float(diff.abs().max() / y_want.abs().max())
                y_err = f"y rel_err={rel:.2e}"
            else:
                y_err = f"y bf16_ulps={bf16_ulps(diff, y_want):.3g}"
            nbytes = sum(t.numel() * t.element_size() for t in args)
            copies = [args] + [tuple(t.clone() for t in args)
                               for _ in range(int(100e6 // nbytes))]
            ms = graph_ms([(lambda c=c: ops.selective_scan_cuda(*c))
                           for c in copies])
            del copies
            print(f"{root} selective_scan B={b} S={s} d={d} n={n} u={udt}: "
                  f"ms={ms:.4f} h_last bit checksum={bits(h_last)} {y_err}",
                  flush=True)
    decode_walls(root, dev)
    return 0


def decode_walls(root: str, dev: str, n_steps: int = 16) -> None:
    """The decode step wall of each main path at full width (4 requests,
    random weights packed by the checkout's ``pack_for_serving``, greedy):
    the eager ``decode_step`` (host clock around each step, synchronised),
    and where the checkout has ``engine.DecodeLoop`` the capture wall and
    each replay of the captured step timed the same way; the greedy tokens
    of the two must agree."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for arch, kv, n_prompt in (("opt-proxy", "fp16", 16),
                               ("internlm2-1.8b", "int8", 512),
                               ("falcon-mamba-7b", "fp16", 512)):
        cfg = get_config(arch)
        cfg.serve.kv_cache = kv
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        packed = pack_for_serving(cfg, T.init_params(cfg.model, gen, dev))
        toks = MarkovLM(cfg.model.vocab_size, seed=3).batch(
            4, n_prompt)["tokens"].to(dev)
        max_len = n_prompt + n_steps + 2
        lg, caches = engine.prefill(cfg, packed, {"tokens": toks}, max_len)
        tok = lg.argmax(-1)
        pos = torch.full((4,), n_prompt, dtype=torch.long, device=dev)
        eager, walls = [tok], []
        for _ in range(n_steps):
            (lg, caches), w = timed(lambda: T.decode_step(
                cfg.model, packed, tok, pos, caches))
            tok = lg.argmax(-1)
            eager.append(tok)
            walls.append(w)
            pos = pos + 1
        del caches, lg
        line = (f"{root} decode step {arch} kv_cache={kv}: eager mean "
                f"{sum(walls) / n_steps:.5f} s median "
                f"{sorted(walls)[n_steps // 2]:.5f} s")
        if hasattr(engine, "DecodeLoop"):
            lg, caches = engine.prefill(cfg, packed, {"tokens": toks},
                                        max_len)
            loop = engine.DecodeLoop(cfg, packed, lg, caches, n_prompt,
                                     n_steps + 1, -1, 0.0, None)
            timed(loop.step)
            graph, cap = timed(loop.capture)
            walls = [timed(graph.replay)[1] for _ in range(n_steps - 1)]
            same = torch.equal(loop.tokens, torch.stack(eager, dim=1))
            line += (f"; capture {cap:.4f} s; replay mean "
                     f"{sum(walls) / len(walls):.5f} s median "
                     f"{sorted(walls)[len(walls) // 2]:.5f} s; greedy "
                     f"tokens equal {same}")
            del graph, loop, caches, lg
        print(line, flush=True)
        del packed
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
