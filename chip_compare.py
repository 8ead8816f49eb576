#!/usr/bin/env python3
"""Time the kernels of one checkout on the card, for parent-vs-change runs.

    python3 chip_compare.py <checkout root> [section ...]

Sections (all but quantize_schedules and gloo_gather by default):
hessian_accum, gptq_block (with rpiq_block), w4a16_matmul,
int8_kv_attention, quant_pack, selective_scan, decode_walls,
quantize_walls, quantize_schedules, gloo_gather. Run it on two checkouts in turns inside one
call on one card (parent, change, change, parent; the parent unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) to
compare them. It prints the checkout's build wall (every kernel from
its sources; near 0 where its build directory already holds them), then,
per line: the checkout, the kernel and shape, and

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
  internlm2's decode shape, S 545 and 4096, and at h2o-danube-1.8b's, B 2,
  R 4, hd 80, one scale block a row, on a 4096-slot ring just past its
  wrap; where the checkout takes ``softcap``, also with softcap 30 at S
  4096; whisper-large-v3's, B 4, KV 20, R 1, hd 64, S 97; minicpm smoke's
  hd 12, a line saying "refused" on a checkout that takes no such width;
  R 8 at hd 256, S 545; recurrentgemma-9b's local layers, B 4, KV 1, R 16,
  hd 256 on a 2048-slot ring, with the fp32 error against the plain
  version beside its pin, "refused" on a checkout taking R <= 8) and
  ``quant_pack`` (the six
  main-path shapes, weights in fp32 and bf16): the device time per call
  from a CUDA graph over copies beyond L2 (``chip_smoke.graph_ms``), the
  error against the plain version (bitwise for ``quant_pack``) and an
  output sum; for ``int8_kv_attention`` also an exact checksum of the
  output's bits, the
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
- the decode step wall of each main path at full width (``decode_walls``);
- ``quantize_walls``: ``quantize_model`` → ``pack_for_serving`` of
  internlm2-1.8b at full width and depth on ``chip_smoke.py`` phase 6's
  calibration (4 x 4 x 128), its wall and stage walls, and a sha256 over
  the packed artifact's tensors (equal across checkouts where the
  artifacts are bitwise equal): the layer walk and plan code every path
  shares;
- ``quantize_schedules`` (not in the default set): the layer walk's two
  schedules (``quant.pipeline`` serial and overlap) in one process, on
  internlm2-1.8b (4 x 4 x 128, phase 6's calibration) and olmoe-1b-7b
  (4 x 4 x 512, phase 11's) at full width and depth, after a warm-up of
  each schedule on a 2-layer cut: ``quantize_model`` in five pairs, the
  pairs taking turns at which schedule runs first, each run's wall,
  summed layer-step walls, quantization peak above the float params and
  a sha256 over its packed tensors, then each schedule's median and
  quartiles and the pairs overlap won; then one run
  of each schedule under ``torch.profiler``: kernel time by CUDA stream,
  the device's busy time (the union of the kernels' intervals) and the
  idle share against the profiled wall;
- ``gloo_gather`` (not in the default set), on a checkout with
  ``repro_torch.distributed.sharding``: two ranks sharing the card over
  gloo (the sharded executor's setting on one card), each holding a
  64 MB fp32 block on the card (half of internlm2-1.8b's (2, 8192, 2048)
  up/gate group): the wall of ``all_gather_cat`` (the executor's join),
  ``broadcast_tree`` (the params' broadcast) and ``psum`` of it, and of
  the host copies the gloo route makes (device → host, host → device),
  as the mean of 5 after one, with GB/s of the block.
"""
import contextlib
import inspect
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sections = set(sys.argv[2:]) or {
        "hessian_accum", "gptq_block", "w4a16_matmul", "int8_kv_attention",
        "quant_pack", "selective_scan", "decode_walls", "quantize_walls"}
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

    t_build = time.perf_counter()
    build.build_all()
    print(f"{root} build: {time.perf_counter() - t_build:.1f} s (every "
          f"kernel, one nvcc a source in parallel; 0 when the build "
          f"directory already holds them)", flush=True)
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
        if "hessian_accum" not in sections:
            break
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
        if "gptq_block" not in sections:
            break
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
    if "w4a16_matmul" not in sections:
        cases = []
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
        if "w4a16_matmul" not in sections:
            break
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

    def kv_row(b, kv, r, hd, s, blk, capped, g):
        """int8_kv_attention at one shape: its timing line(s)."""
        codes = torch.randint(-127, 128, (2, b, s, kv, hd), generator=g,
                              device=dev).to(torch.int8)
        scales = torch.rand((2, b, s, kv, hd // blk), generator=g,
                            device=dev) * 0.02 + 1e-3
        kpos = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
        ring = hd in (80, 256)
        if ring:                    # a ring after position 4100
            kpos = 4100 - (4100 - kpos) % s
        cache = (codes[0], scales[0], codes[1], scales[1], kpos)
        q32 = (torch.randn((b, kv, r, hd), generator=g, device=dev)
               * hd ** -0.5)
        q = q32.to(torch.bfloat16)
        fp32 = ""
        if r > 8:
            # the fp32 pin of chip_smoke.py phase 3: 1e-5 of the largest
            got32 = ops.int8_kv_attention_cuda(q32, *cache, blk)
            want32 = ref.int8_kv_attention(q32, *cache, blk)
            fp32 = (f" fp32 max_abs_err={float((got32 - want32).abs().max()):.3e}"
                    f" (tol {1e-5 * float(want32.abs().max()):.3e})")
        caps = (0.0, 30.0) if capped and s == 4096 and blk != 64 else (0.0,)
        for cap in caps:
            kw = {"softcap": cap} if capped else {}
            q_in = q * 40.0 if cap else q       # scores the cap bends

            def kern(c, q_in=q_in, kw=kw):
                return ops.int8_kv_attention_cuda(q_in, *c, blk, **kw)

            out = kern(cache)
            same = torch.equal(out, kern(cache))
            out_bits = bits(out)
            out = out.float()
            err = float((out - ref.int8_kv_attention(
                q_in, *cache, blk, **kw).float()).abs().max())
            splits = (ops.int8_kv_attention_geometry(b, kv, s)[0]
                      if hasattr(ops, "int8_kv_attention_geometry") else 1)
            nbytes = sum(t.numel() * t.element_size() for t in cache)
            copies = [cache] + [tuple(t.clone() for t in cache)
                                for _ in range(int(100e6 // nbytes))]
            ms = graph_ms([(lambda c=c: kern(c)) for c in copies])
            sweep = ""
            if (hasattr(ops, "int8_kv_attention_geometry") and blk == 128
                    and not cap):
                # every range length, the sweep the geometry rests on
                # R 16 has a source of its own, whose launch takes no R
                r16 = r > 8
                lib = build.load("int8_kv_attention_r16" if r16
                                 else "int8_kv_attention")
                fn = (lib.int8_kv_attention_r16_bf16_launch if r16
                      else lib.int8_kv_attention_bf16_launch)
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
                        err = fn(
                            q.data_ptr(), *(t.data_ptr() for t in c),
                            o.data_ptr(), b, s, kv, *([] if r16 else [r]),
                            hd, blk, n_sp, per,
                            wk, tk, *([0.0] if capped else []),
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"launch failed: {err}")
                    times.append((per, n_sp, graph_ms(
                        [(lambda c=c: launch(c)) for c in copies])))
                sweep = " sweep (tiles a range, ranges, ms): " + " ".join(
                    f"({p_},{n_},{t_:.4f})" for p_, n_, t_ in times)
            del copies
            host = ""
            if s == 545:
                call = (lambda: kern(cache))
                host = (f" ms per wrapper call (host-bound loop) "
                        f"{event_ms(call, 500):.5f}, host enqueue ms per "
                        f"call {host_ms(call)}")
            print(f"{root} int8_kv_attention B={b} R={r} hd={hd} S={s} "
                  f"kv_block={blk}{' ring' if ring else ''} "
                  f"softcap={cap}: ms={ms:.4f} max_abs_err={err:.3e}{fp32} "
                  f"sum={float(out.double().sum())} bit checksum="
                  f"{out_bits} history ranges={splits} "
                  f"two launches bitwise equal {same}{host}{sweep}",
                  flush=True)

    if ("int8_kv_attention" in sections
            and hasattr(ops, "int8_kv_attention_cuda")):
        capped = "softcap" in inspect.signature(
            ops.int8_kv_attention_cuda).parameters
        # internlm2's decode shape, then h2o-danube's (hd 80, block 80),
        # whisper-large-v3's decoder self-cache (R 1, hd 64, 64 + 32 + 1
        # slots), then minicpm smoke's hd 12, which a checkout taking only
        # multiples of 16 refuses; R 8 at hd 256 (the widest instantiation
        # a checkout taking R <= 8 has); recurrentgemma-9b's local layers
        # (R 16, hd 256, a 2048-slot ring), which such a checkout refuses
        for shape in ((4, 8, 2, 128, 545, 128), (4, 8, 2, 128, 4096, 128),
                      (4, 8, 2, 128, 4096, 64), (2, 8, 4, 80, 4096, 80),
                      (4, 20, 1, 64, 97, 64), (2, 2, 2, 12, 40, 12),
                      (2, 2, 8, 256, 545, 128), (4, 1, 16, 256, 2048, 128)):
            try:
                kv_row(*shape, capped, g)
            except ValueError as e:
                print(f"{root} int8_kv_attention {shape}: refused ({e})"[:200],
                      flush=True)

    if "quant_pack" in sections and hasattr(ops, "quant_pack_cuda"):
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
        if "selective_scan" not in sections:
            break
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
    if "decode_walls" in sections:
        decode_walls(root, dev)
    if "quantize_walls" in sections:
        quantize_walls(root, dev)
    if "quantize_schedules" in sections:
        quantize_schedules(root, dev)
    if "gloo_gather" in sections:
        gloo_gather(root)
    return 0


def gloo_rank(rank: int, world: int, root: str, rendezvous: str) -> None:
    """One rank of ``gloo_gather``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    ag = sharding.AxisGroup(dist.group.WORLD, world, rank,
                            tuple(range(world)))
    x = torch.randn((2, 4096, 2048), device="cuda")
    nbytes = x.numel() * x.element_size()

    def wall(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps

    host = x.cpu()
    walls = {"all_gather_cat": wall(lambda: sharding.all_gather_cat(
                 x, 1, ag)),
             "broadcast_tree": wall(lambda: sharding.broadcast_tree(x)),
             "psum": wall(lambda: sharding.psum(x, dist.group.WORLD)),
             "device to host": wall(lambda: x.cpu()),
             "host to device": wall(lambda: host.to("cuda"))}
    if rank == 0:
        for name, sec in walls.items():
            print(f"{root} gloo_gather {world} ranks, {nbytes} bytes a "
                  f"rank: {name} {sec * 1e3:.1f} ms "
                  f"({nbytes / sec / 1e9:.2f} GB/s of the block)",
                  flush=True)
    dist.destroy_process_group()


def gloo_gather(root: str, world: int = 2) -> None:
    import tempfile
    import torch.multiprocessing as mp
    try:
        from repro_torch.distributed import sharding  # noqa: F401
    except ImportError:
        print(f"{root} gloo_gather: no distributed.sharding", flush=True)
        return
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(gloo_rank, args=(world, root, os.path.join(d, "rdv")),
                 nprocs=world)


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


def quantize_walls(root: str, dev: str) -> None:
    """quantize_model → pack_for_serving of internlm2-1.8b at full width
    and depth from seeded random weights on 4 x 4 x 128 calibration tokens
    (chip_smoke.py phase 6): the walls, and a sha256 over every tensor of
    the packed tree in path order."""
    import hashlib
    import torch
    from chip_smoke import tensors_of
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T

    cfg = get_config("internlm2-1.8b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, dev)
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7), 4,
                                4, 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_q, report = quantize_model(cfg, params, calib)
    packed = pack_for_serving(cfg, params_q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = hashlib.sha256()
    for t in tensors_of(packed):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    rest = report.seconds_total - report.seconds_stage1 \
        - report.seconds_stage2
    print(f"{root} quantize internlm2-1.8b: quantize+pack {wall:.3f} s, "
          f"quantize_model {report.seconds_total:.3f} s (stage1 "
          f"{report.seconds_stage1:.3f} stage2 {report.seconds_stage2:.3f} "
          f"rest {rest:.3f}); packed sha256 {h.hexdigest()[:16]}",
          flush=True)
    del params, params_q, packed
    torch.cuda.empty_cache()


def quantize_schedules(root: str, dev: str) -> None:
    """The two schedules of the layer walk, timed and hashed in one
    process (module docstring)."""
    import hashlib
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import tensors_of
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T

    def run(arch, calib_shape, pipeline, layers=0, prof=False):
        cfg = get_config(arch)
        cfg.quant.pipeline = pipeline
        if layers:
            cfg.model.num_layers = layers
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = T.init_params(cfg.model, gen, dev)
        calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7),
                                    *calib_shape)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if prof
               else contextlib.nullcontext())
        with ctx as p:
            t0 = time.perf_counter()
            params_q, report = quantize_model(cfg, params, calib)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        del params
        packed = pack_for_serving(cfg, params_q)
        del params_q
        h = hashlib.sha256()
        for t in tensors_of(packed):
            h.update(t.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
        del packed
        torch.cuda.empty_cache()
        steps = sum(report.layer_step_seconds)
        line = (f"{root} quantize_schedules {arch} {pipeline}"
                f"{f' ({layers}-layer warm-up)' if layers else ''}"
                f"{' (profiled)' if prof else ''}: quantize_model "
                f"{wall:.3f} s, summed layer steps {steps:.3f} s, stage "
                f"seconds s1={report.seconds_stage1:.3f} "
                f"s2={report.seconds_stage2:.3f}, peak {peak} bytes "
                f"above the float params, packed sha256 "
                f"{h.hexdigest()[:16]}")
        if prof:
            spans, by_stream = [], {}
            for e in p.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and \
                        e.time_range.elapsed_us() > 0:
                    spans.append((e.time_range.start, e.time_range.end))
                    sid = getattr(e, "device_resource_id", None)
                    by_stream[sid] = by_stream.get(sid, 0.0) + \
                        e.time_range.elapsed_us() / 1e6
            busy, end = 0.0, None
            for a, b in sorted(spans):
                if end is None or a > end:
                    busy += b - a
                    end = b
                elif b > end:
                    busy += b - end
                    end = b
            busy /= 1e6
            line += (f"; kernel seconds by stream "
                     f"{ {k: round(v, 3) for k, v in by_stream.items()} }, "
                     f"device busy {busy:.3f} s, idle share "
                     f"{1 - busy / wall:.3f}")
        if report.pipeline_stats.get("spec_captures"):
            line += f"; pipeline {report.pipeline_stats}"
        print(line, flush=True)
        return wall

    for arch, calib_shape in (("internlm2-1.8b", (4, 4, 128)),
                              ("olmoe-1b-7b", (4, 4, 512))):
        for pipeline in ("serial", "overlap"):
            run(arch, calib_shape, pipeline, layers=2)      # warm-up
        walls = {"serial": [], "overlap": []}
        for i in range(5):
            order = ("serial", "overlap") if i % 2 == 0 \
                else ("overlap", "serial")
            for pipeline in order:
                walls[pipeline].append(run(arch, calib_shape, pipeline))
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in walls.items()}
        wins = sum(o < s for s, o in zip(walls["serial"], walls["overlap"]))
        print(f"{root} quantize_schedules {arch}: quantize_model wall "
              f"quartiles (s) serial {q['serial'].round(3).tolist()}, "
              f"overlap {q['overlap'].round(3).tolist()}; overlap / serial "
              f"medians {q['overlap'][1] / q['serial'][1]:.4f}; overlap "
              f"faster in {wins} of 5 pairs", flush=True)
        for pipeline in ("serial", "overlap"):
            run(arch, calib_shape, pipeline, prof=True)


if __name__ == "__main__":
    sys.exit(main())
