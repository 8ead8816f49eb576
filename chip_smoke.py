#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py quantize-depth    # not a phase: recurrentgemma-9b
                                            # quantized at all 38 layers

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: name, count, and ``nvidia-smi`` name / power limit;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
     nvcc (in parallel), printing each kernel's ptxas registers, shared
     memory and spills;
  3. kernels: each of the eight kernels' wrappers against its plain
     PyTorch version on the card, at the shapes the main paths give it
     (opt-proxy, internlm2-1.8b, falcon-mamba-7b, phase 9's
     h2o-danube-1.8b and pixtral-12b, and phase 10's whisper-large-v3;
     ``int8_kv_attention`` also at minicpm smoke's head width 12), with
     the error
     against the stated tolerance and CUDA-event times (kernel, plain,
     library yardstick where one exists, itself held against the plain
     version) beside the least time the card could take (bf16
     ``w4a16_matmul`` at the bf16 tensor-core rate, the rest at fp32 on the
     CUDA cores); two launches of ``hessian_accum`` and
     ``int8_kv_attention``, and of ``w4a16_matmul`` where it splits k over
     blocks, on the same inputs must agree bitwise; ``w4a16_matmul`` also
     at groups 8 and 16 in bf16 and at k 12288 in fp32,
     ``int8_kv_attention`` at one history range and with ranges of -1
     slots only, at h2o-danube-1.8b's ring shape (hd 80, one scale block a
     row, slots past the wrap) and with the soft cap (there and at
     internlm2's shape), ``rpiq_block`` on 8 seeded instances of its two
     narrowest groups, ``gptq_block`` and ``rpiq_block`` at blocksizes
     256 and in (the wide paths), ``quant_pack`` in fp32 and bf16, and
     the scan's backward ``selective_scan_bwd`` at falcon-mamba-7b's
     training shapes (S 512, 128 and a ragged 77; u fp32 and bf16; two
     launches bitwise equal);
     phase 11's shapes (``kernels_moe_shapes``): the stacked expert groups
     of 128 and 64 lanes on zero-padded capacity buffers (n 320, per-lane
     ``x_count``, starved lanes) and ``quant_pack`` at (65536, 2048) and
     (131072, 1024); phase 12's (``kernels_continuous_shapes``):
     ``int8_kv_attention`` at B 8 over a 1024-slot slotted cache of mixed
     lane lengths (empty lanes among them) and bf16 ``w4a16_matmul`` at
     m 8 (the tick) and m 128 (a prefill chunk) at internlm2's (k, n);
     phase 13's (``kernels_hybrid_shapes``): recurrentgemma-9b's groups
     at n 2048, its (k, n) at m 4 and ``int8_kv_attention`` at R 16, hd
     256 on a 2048-slot ring; phase 14's (``kernels_mla_shapes``):
     deepseek-v3-671b's dense-layer groups at n 2048, its (k, n) at m 4
     and k_up / v_up's (512, 16384) at m 2180 (4 x 545 latents);
  4. small end to end: opt-proxy smoke (bf16 cache), internlm2 smoke (int8
     KV cache) and falcon-mamba smoke (recurrent state) quantized, packed
     and served on the card against the same runs of the plain versions on
     the CPU in fp32; then each at its own bf16 and group size (16, 8, 8)
     on the card, its first layer's kernel calls held at one bf16 ulp;
     then the same two runs for h2o-danube smoke (an int8 ring of 8
     slots), minicpm smoke (tied embeddings; k 72 padded for
     ``w4a16_matmul``; the int8 cache at head width 12), stablelm smoke (LayerNorm), pixtral smoke (8
     patch embeddings in every calibration batch and request), olmoe
     smoke (routed experts, the int8 cache), recurrentgemma smoke (RG-LRU
     and a local int8 ring) and deepseek smoke (MLA over a bf16 latent
     cache under the int8 setting, its ``mtp_logits`` held too); then
     olmoe smoke on a
     calibration short enough to starve experts, its RTN lanes bitwise
     the CPU's; then every smoke family (whisper's too), card against
     CPU in fp32: the chunked prefill, a short continuous run (2 lanes,
     prefill chunk 3; the card's ticks replay a graph) and the
     guardrail ladder with ``hessian.cholesky@1:nonpsd`` and ``@1:nan``
     armed (the same ``guardrail_stats`` and record modes); then
     internlm2 smoke (GQA, bf16 cache) and whisper smoke (cross-attention)
     under ``model.opt_attention=false`` (the naive attention baseline),
     card against CPU in fp32 (prefill logits, greedy tokens) and bf16
     (prefill logits);
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
  7. the Mamba-1 main path at full width: falcon-mamba-7b (d_model 4096,
     d_inner 8192, d_state 16) cut to 8 of its 64 layers since phase 16
     (the run's time) → quantize_model →
     pack_for_serving → generate (4 requests x 512 prompt + 32 new
     tokens), counters reset and read around it (``selective_scan`` at
     prefill, capture and propagate); the packed-vs-float logits and the
     prefill → decode state hand-off, both in fp32 compute;
  8. the entry points at full width, each launcher's ``main(argv)`` in
     this process with the launch counters reset and read around it,
     artifacts and checkpoints in fresh directories under build/phase8
     (removed at the end), ``train.ckpt_dir`` an empty one:
     8a. ``launch.quantize --arch opt-proxy`` at the launcher's own
         calibration (8 x 16 x 512 tokens: stage 2 sees n 8192), then
         ``launch.serve --params`` on its artifact: the artifact (sha256)
         and the served tokens bitwise those of quantize_model →
         pack_for_serving → generate called directly on the same seeded
         weights and batches; layer 0's ``rpiq_block`` calls at n 8192 and
         ``hessian_accum`` at n 8192 against their plain versions at phase
         3's pins; a copy of the artifact with one flipped byte refused
         with ``ArtifactIntegrityError``;
     8b. the same quantize run with ``quant.ckpt_dir`` and
         ``quant.resume=auto``, interrupted after step 6 of 12 (a wrapper
         of the plan executor raises), then resumed: its artifact's sha256
         equal to 8a's (else the leaves that differ are printed);
     8c. ``launch.serve --arch internlm2-1.8b --pack-rtn
         serve.kv_cache=int8`` at full width and depth, 8d. ``launch.serve
         --arch falcon-mamba-7b --pack-rtn model.num_layers=8`` (4 requests
         x 512 prompt + 32 new tokens each): tokens equal to
         pack_for_serving → generate called directly;
     8e. ``examples/torch_quickstart.py`` and
         ``examples/torch_quantize_and_serve.py`` on the card;
     8f. 8a's ``launch.quantize`` with ``quant.pipeline=overlap``: its
         artifact's sha256 equal to 8a's;
     8g. the overlap run checkpointed and killed by the fault plane
         (``faults.arm=plan.stage1_executor@19``, in layer 7 of 12), then
         resumed without ``faults.arm``: the checkpoint's fingerprint
         ignores the arming, the run resumes at walk item 6 and its
         sha256 equals 8a's;
     with the walls (quantize total and stages, checkpoint save per step,
     artifact bytes and save / load, prefill, capture, replayed step and
     serve total) beside the card's name and power limit;
  9. the other dense architectures at full width:
     9a. h2o-danube-1.8b at full width (window 4096, head_dim 80), cut
         to 4 of its 24 sliding-window layers since phase 16 (the run's
         time) → quantize_model → pack_for_serving →
         generate on the int8 ring (2 requests x 4608 prompt tokens + 32
         new: the prefill keeps the last 4096 positions), then generate
         again on 4080-token prompts with the int8 and the bf16 ring, whose
         decode crosses the wrap at 4096 inside the replayed graph; each
         serve's replay bitwise the eager loop; each leg's first decode
         steps (20 across the wrap) in fp32 compute against full-length
         caches that the window masks (1e-4); the ring's rows and bytes
         against a full-length cache; the int8-vs-bf16 drift rule of
         phase 6 across the wrap;
     9b. pixtral-12b at full width, cut to 4 of 40 layers (26 fit
         quantization, which holds the float layers before and after;
         13 kept the whole run near 1000 s once phases 13 and 14 came
         in, 4 since phase 16), 1024 seeded patch
         embeddings in every calibration batch (4 x 2 x 128 tokens) and
         request (2 x 64 + 32 new): the replay bitwise eager, decode from
         position 64 + 1024, packed int4 against refined float logits in
         fp32 compute (1e-3; bf16 printed); then ``launch.serve --arch
         pixtral-12b --pack-rtn`` at all 40 layers, its tokens those of
         pack_for_serving → generate called directly;
  10. the encoder-decoder path at full width: whisper-large-v3 (d 1280,
     20 heads of 64, no RoPE), cut to 4 encoder and 4 decoder layers of
     its 32 + 32 since phase 16 (the run's time)
     from seeded random weights, 1500 seeded frames in every calibration
     clip (4 batches x 2 x 256 tokens) and request (4 x 64 tokens + 32
     new) → quantize_model (the encoder walk, the enc→dec switch, the
     decoder walk) → pack_for_serving → generate with the bf16 and the
     int8 self-cache (the cross-attention cache in bf16), each replay
     bitwise its eager loop; 10 calibrated and 6 RTN-packed linears a
     layer;
     the cache bytes, the int8 drift rule, the packed logits against the
     refined float logits and the prefill → decode hand-off against the
     full forward in fp32 compute; then ``launch.serve --arch
     whisper-large-v3 --pack-rtn`` at the same depth, its tokens those of
     pack_for_serving → generate called directly;
  11. the routed-MoE path at full width and depth: olmoe-1b-7b (16
     layers, d 2048, 64 experts, top 8, d_ff_expert 1024), calibration 4
     batches x 4 x 512 tokens (expert capacity 320 rows) → quantize_model
     (stacked per-expert Hessians; expert groups of 128 and 64 lanes) →
     pack_for_serving → generate on the int8 cache (4 requests x 512
     prompt + 32 new), the replay bitwise the eager loop; each
     ``gptq_block`` / ``rpiq_block`` call's device time by group, capacity
     drops and starved lanes, the packed experts bitwise the refined ones
     in bf16, the packed logits against the refined float logits in fp32
     compute on the same routing (1e-2: the experts compute in bf16), the
     int8 drift rule, the artifact bytes;
  12. the continuous path at full width and depth: internlm2-1.8b
     (RTN-packed seeded weights, the int8 cache) behind
     ``ContinuousEngine`` (8 lanes, prefill chunks of 128, max_len
     1024), 24 seeded requests (prompts 32-512 tokens, budgets 16-64)
     drained with the counters reset just before and read just after:
     ticks, eager and replayed tick walls, prefill-chunk walls, per-request
     time to first token and total, tokens/s, capture wall, a replayed
     tick's idle share, peak memory; held: chunked against single-shot
     prefill (fp32 compute and cache, 1e-4), the replayed tick bitwise
     the eager tick, row independence, a ``serve.decode_step`` quarantine
     that leaves every other request's tokens bitwise the fault-free
     run's, and a ``serve.engine_step`` kill under ``SupervisedEngine``
     that completes every request within its budget (how many come out
     token-identical is reported);
  13. the RG-LRU hybrid at full width: recurrentgemma-9b (d 4096, 16
     heads over one kv-head of 256, d_ff 12288, vocab 256000 tied) cut to
     3 of 38 layers (a whole period: all 38 fit quantization, 77.8 GB
     at its peak, but 12 kept the run inside its time limit once phase
     15 came in, 6 since phase 16, 3 since 17a's recurrentgemma and
     deepseek legs),
     calibration 4 x 4 x 512 → quantize_model → pack_for_serving →
     generate on the bf16 ring and the int8 ring (4 x 512 + 32), then 1 x
     2040 + 32 on the int8 ring across its wrap, each replay bitwise its
     eager loop; packed against refined logits in fp32 compute, chunked
     against single-shot prefill, the decode state's bytes; then
     ``launch.serve --arch recurrentgemma-9b --pack-rtn`` at 38 layers;
  14. multi-head latent attention at full width: deepseek-v3-671b cut to
     its 3 dense layers with the MTP head (a routed layer's 256 experts do
     not fit one card), calibration 4 x 4 x 512 → quantize_model →
     pack_for_serving (the MTP layer RTN-packed) → generate on the bf16
     latent cache (4 x 512 + 32), the replay bitwise eager; packed against
     refined logits and MTP logits in fp32, chunked against single-shot
     prefill, the latent cache's bytes against the expanded K/V's;
  15. the overlap schedule at full width and depth: olmoe-1b-7b on phase
     11's weights and calibration (4 x 4 x 512) and internlm2-1.8b on
     phase 6's (4 x 4 x 128), each ``quantize_model`` under
     ``quant.pipeline=overlap`` (the next layer's capture ahead on a side
     CUDA stream), its packed artifact held leaf by leaf by sha256 against
     that phase's serial run, its report (modes, iterations, Γ
     histories, capacity drops) equal to it; the whole ``pipeline_stats``,
     the serial (phases 6 and 11) and overlap walls, summed layer-step
     walls and quantization peaks beside the card; then each model cut to
     2 layers, quantized under overlap inside ``torch.profiler``: the
     ``hessian_accum`` kernels of the speculative capture on a second
     stream; the bytes held on the card before it (and before phase 16)
     are printed;
  16. training on the card (the reference's training runs no Pallas
     kernel; the Mamba step's scan has its backward, ``selective_scan_bwd``,
     and every other CUDA wrapper refuses inputs that require grad):
     16a. full-width opt-proxy (12 layers, d 768, vocab 50304; fp32
         master weights, bf16 compute) through ``launch.train``: 150
         steps (cut from 300, for time) of 16 x 128 tokens at lr
         1e-3 on ``MarkovLM(branching=3)`` (the loss must fall; step
         walls, peak, a profiled step's idle share); the same run
         stopped by SIGTERM half-way (the stream sends it as it makes
         batch 77; the trainer checkpoints at the
         next step boundary and returns) and rerun: its final TrainState
         bitwise the uninterrupted one's, the data stream's position
         included; ``launch.quantize train.ckpt_dir=`` on the
         trained checkpoint (the linears stage 2 improved, beside phase
         8a's count on random weights), held-out CE of the float, RPIQ
         int4 and RTN int4 models and their logit gaps, ``launch.serve
         --params`` on the trained artifact;
     16b. internlm2-1.8b at full width and depth: five steps of 4 x 512
         tokens under ``parallel.remat=full``, with fp32 and with int8
         AdamW moments: finite, falling losses, step walls, peaks and the
         optimizer state's bytes (int8 ~4x smaller);
     16c. falcon-mamba-7b at full width (d_model 4096, d_inner 8192, n
         16, vocab 65024) cut to 2 of its 64 layers through
         ``launch.train`` (remat full, fp32 master, bf16 compute): the loss
         falls, ``selective_scan_bwd`` launches once a layer a step; the
         same batch's gradients twice bitwise; in fp32 the gradients
         against the same step through the plain scan's autograd on the
         card, per leaf at 1e-5; falcon-mamba smoke's fp32 gradients on the
         card against the CPU's;
  17. sharded quantization (``quant.mesh``) with ranks that share the one
     card over gloo (NCCL refuses two ranks a device); the kernels are
     built (phase 2) before the ranks start, and every rank launches the
     hand-written ``gptq_block`` / ``rpiq_block`` on its shard:
     17a. opt-proxy at full width on 2x2, 4 ranks spawned here, each
         calling ``quantize_model(cfg)`` on phase 5's seeded weights and
         calibration; against phase 5's single-device run (at most 1e-3 of
         the cells off at rtol 1e-5 / atol 1e-6, names and modes equal);
         then the same ranks train it on a 2x2 mesh (``train(cfg,
         mesh=)``: explicit data parallelism over ``data``, the train
         state sharded by the placement rules, the ``model`` axis
         computing its share: attention by heads, the MLP by ``d_ff``,
         the embedding, head and loss by vocab): 4 steps of 16 x 128
         under ``parallel.remat=full`` from the seeded init, then 2 steps
         from the same init under ``parallel.sp`` (the residual's
         sequence over ``model``), each against one run of
         ``train(device="cuda")`` from the same init, on rank 0, at its
         step 5 and step 2 (losses within 1e-2, each leaf at 1e-5 or,
         past it, at the JAX package's sharded pins rtol 3e-2 / atol
         3e-3), every rank's final state bitwise rank 0's, rank 0's
         checkpoint of the split run restored on one device bitwise; each
         rank's step walls, gloo bytes a step (by kind, beside the
         1,136,099,332 before the split) and peak; then the same ranks
         on 1x4 (``split_train_rank``): falcon-mamba-7b at full width, 2
         of its 64 layers, bf16 compute (Mamba split by ``d_inner``:
         2048 channels a rank, ``selective_scan`` / ``selective_scan_bwd``
         at d 2048, the [u | z] in projection re-blocked by an
         all-to-all), and olmoe-1b-7b at full width, 1 of its 16 layers,
         fp32 compute (16 of 64 experts a rank, the routing whole; the
         attention by heads), each 2 steps of 4 x 256 through
         ``make_sharded_train_step`` under ``parallel.remat=full``, then 1
         under ``parallel.sp``, from the seeded init, against the
         one-device step run first on each rank in its turn (every
         rank's blocks of it kept): losses within 1e-2, each
         leaf at 1e-5 or the JAX sharded pins, the experts' at 1e-2;
         every rank's losses and replicated leaves bitwise rank 0's; the
         scan kernels' launches at d 2048 counted (twice forward, once
         backward, a layer a step); each rank's step walls, gloo bytes by
         kind, peak and the row-parallel products' input widths; the
         same for recurrentgemma-9b at full width, one period of 3 of its
         38 layers, bf16 compute (RG-LRU by ``lru_width``: 1024 of 4096
         channels a rank, u all-gathered for rg / ig; the local MQA
         layer's 4 q-heads a rank over the one kv-head; the tied 256000
         vocab by rows; its blocks of the one-device states kept in
         pinned host memory); then deepseek-v3-671b at full width, its dense
         layer and the MTP head, fp32 (``split_grads_rank``: its train
         step does not fit four ranks beside a one-device run on the
         card): the loss and every gradient, forward and backward, on 1x4
         (32 of 128 MLA heads a rank, its latents whole; the MTP
         projection at 1792 of 7168 columns; d_ff and the vocab split)
         and under ``parallel.sp``, against one device's on each rank in
         its turn: the loss at 1e-5, each gradient leaf at 1e-5 or, past
         it, 1e-4 relative; every rank's replicated gradients bitwise
         rank 0's;
     17b. internlm2-1.8b at full width, 4 of its 24 layers (for
         time), on 1x2 (every group
         row-sharded: the Γ sum at 2048-8192 rows) through
         ``torch.distributed.run`` (``python3 chip_smoke.py launcher-rank
         <argv>`` is one rank of ``launch.quantize``), against the same
         launcher alone without the mesh, run beside it: the artifacts'
         cells, the reports' names and modes, the ranks' artifact
         digests;
     17c. olmoe-1b-7b at full width on 1x1x2 under overlap (its
         records deferred, no stage waiting), cut to one layer, after the
         one-device run of the same cut has measured one rank's peak (the
         smoke config if two would not fit), against that run;
     each leg prints its wall, each rank's launches at its shard shapes
     and peak, and whether every rank's packed artifact and quantized
     leaves are bitwise rank 0's; a failed rank fails the run;
  18. the fault plane's process-level checks and the shape-only dry run
     (18a's process and the dry run's reckonings of 18c (2) and (3), host
     processes that do not see the card, start before phase 13 and run
     beside phases 13 and 14; phase 18 reads them after 18b and 18c (1)):
     18a. ``scripts/torch_resume_smoke.py --int8-only`` on the card: the
         clean launcher run beside one killed by ``plan.stage1_executor@4``
         under ``serve.kv_cache=int8``, its resumed run bitwise the clean
         artifact leaf by leaf, then ``launch.serve`` on the int8-KV
         continuous path; each child's wall, the digests and the
         children's kernel launches (the fp16-KV pass runs in the CPU
         test);
     18b. ``scripts/torch_chaos_soak.py --seeds 0 --smoke --device cuda``:
         no violation of S1-S4 or Q1-Q3;
     18c. the dry run held against what this script measures: (1)
         opt-proxy's decode step at phase 5's shapes (packed weights, 4
         lanes) and internlm2-1.8b's 4 x 512 train step (phase 16b's)
         traced on fake CUDA tensors on a mesh of one, each kernel
         wrapper called as often as the eager step launched it, the
         traced live-bytes high-water against ``max_memory_allocated``
         inside ``DRYRUN_PEAK_RATIO``; (2) ``--quant-cell --arch
         deepseek-v3-671b --quant-mesh 1x2x256`` and internlm2-1.8b's
         ``train_4k`` on 16x16, their per-rank peaks; (3) the
         quantization walks of recurrentgemma-9b at 33 and 38 layers and
         pixtral-12b at 26 and 40 (their phases' calibration), against
         the peaks measured at 33 and 26 (``DRYRUN_MEASURED``) inside the
         same bound, and whether the full depths fit the card.
Each phase's wall is printed; phase 3's by kernel section too. Its stage
kernels' plain versions are timed by the one call their checks make
(``once_ms``).

The line before the last is a JSON object with one entry per kernel
(``launches`` sums phases 5 to 18, every rank's and child's); the last line is ``{"ok": true,
"device": {...}}``.

The process's CUDA allocator grows its segments in place
(``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` unless the caller
sets the variable): phases 11 and 15 quantize olmoe-1b-7b within ~8 GiB
of the card, and under the overlap schedule blocks freed on one stream
are cached for that stream alone, so fixed-size segments could strand
more than that margin (``launch.quantize`` sets the same default).
Between phases the host's garbage is collected before the allocator's
cache is emptied: an engine whose tick a phase wrapped in a closure is a
reference cycle that would keep its weights and cache on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# read when the CUDA allocator starts, so set before torch touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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
    # no Pallas counterpart: the VJP of the reference's XLA scan
    "selective_scan_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/ops.py:739"),
}


# phase 4's other dense smoke configs and the cache each serves with:
# h2o-danube's int8 ring of 8 slots wraps within its 8 + 6 positions;
# minicpm smoke's head width 12 takes int8_kv_attention's 4-byte rows
SMALL_DENSE = (("h2o-danube-1.8b", "int8"), ("minicpm-2b", "int8"),
               ("stablelm-1.6b", "fp16"), ("pixtral-12b", "fp16"),
               ("olmoe-1b-7b", "int8"), ("recurrentgemma-9b", "int8"),
               ("deepseek-v3-671b", "int8"))


# phase 4's chunked prefill, continuous run and guardrail ladder: every
# smoke family, the encoder-decoder among them
SMALL_SERVING = (("opt-proxy", "fp16"), ("internlm2-1.8b", "int8"),
                 ("falcon-mamba-7b", "fp16")) + SMALL_DENSE + (
                     ("whisper-large-v3", "int8"),)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def time_ms(fn, min_total_s: float = 0.2, max_reps: int = 50,
            warm: bool = False) -> float:
    """Mean CUDA-event time of fn() after one warm-up call (for calls long
    enough that the host's launch cost hides behind the device); one call
    that alone lasts ``min_total_s`` is its own reading. ``warm``: the
    caller has just made the same call (its check's), which stands for
    the warm-up."""
    import torch
    if not warm:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = start.elapsed_time(end)
    if once >= min_total_s * 1e3:
        return once
    reps = int(max(1, min(max_reps, min_total_s * 1e3 / max(once, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """``(fn(), its CUDA-event time in ms)``: a plain version timed by the
    one call its check makes (its time is a reading, not a yardstick, and
    its repeats were most of phase 3's wall). A short plain version's time
    so includes its launches from the host (``w4a16_matmul`` and
    ``int8_kv_attention`` at decode)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def release_device() -> None:
    """Free what the phases before left unreferenced: collect reference
    cycles first, then return the allocator's cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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


def check_path_launches(launches: dict, path: str, absent: tuple) -> None:
    """Every kernel launched on a serving or quantization path but those
    in ``absent`` and the scan's backward (training's alone), which must
    not be."""
    for name, n in launches.items():
        if name in absent or name == "selective_scan_bwd":
            check(n == 0, f"{name} launched on the {path}")
        else:
            check(n > 0, f"kernel {name} was not launched on the {path}")


def resolve(tree, path: str):
    for k in path.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def frac_differing(a, b, tol_abs: float = 0.0, tol_rel: float = 0.0):
    d = (a - b).abs()
    return float((d > tol_abs + tol_rel * b.abs()).float().mean())


class Sections:
    """Phase 3's wall by kernel section: ``with walls("name"):`` times a
    section (the card synchronised at both ends); ``report()`` prints
    them, largest first."""

    def __init__(self):
        self.s: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t

    def report(self) -> None:
        total = sum(self.s.values())
        for name, sec in sorted(self.s.items(), key=lambda kv: -kv[1]):
            log(f"  phase 3 section {name}: {sec:.1f}s "
                f"({100 * sec / total:.1f} %)")


def phase_kernels(table: KernelTable) -> None:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n_tok, gs, bs, t_max, alpha = 512, 128, 128, 5, 0.01
    walls = Sections()

    # -- hessian_accum: H += X^T X (opt-proxy d, internlm2 d, falcon-mamba
    # d: 256 for dt, 4096 for in, 8192 for x and out) -----------------------
    with walls("hessian_accum"):
        for d in (768, 3072, 2048, 8192, 256, 4096):
            check_hessian_accum(table, g, n_tok, d)

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
    with walls("w4a16_matmul"):
        for m, k, n in cases:
            for dt in ((torch.bfloat16, torch.float32) if (m, k, n) ==
                       (4, 768, 768) else (torch.bfloat16,)):
                check_w4a16(table, g, m, k, n, dt, gs)
        kernels_w4a16_other_groups()

    # -- gptq_block and rpiq_block on realistic Hessians ---------------------
    # opt-proxy's three groups, internlm2's q / o, k+v, gate+up, down, then
    # falcon-mamba's in, x (288 rows: dt_rank 256 + 2 x 16), dt, out
    with walls("gptq_block + rpiq_block groups"):
        for b, out_dim, in_dim in ((4, 768, 768), (1, 3072, 768),
                                   (1, 768, 3072), (1, 2048, 2048),
                                   (2, 1024, 2048), (2, 8192, 2048),
                                   (1, 2048, 8192), (1, 16384, 4096),
                                   (1, 288, 8192), (1, 8192, 256),
                                   (1, 4096, 8192)):
            case = group_case(g, b, out_dim, in_dim, n_tok)
            w0, scales, zeros = check_gptq(case, gs, bs, table)
            check_rpiq(case, w0, scales, zeros, gs, bs, t_max, alpha, table)
    with walls("rpiq_block seeds"):
        kernels_rpiq_seeds(n_tok, gs, bs, t_max, alpha)
    with walls("blocksizes"):
        kernels_blocksizes(n_tok, gs, t_max, alpha)

    for name, fn in (
            ("int8_kv_attention", lambda: kernels_int8_kv_attention(table,
                                                                    g)),
            ("int8_kv_attention ring",
             lambda: kernels_int8_kv_attention_ring(table)),
            ("quant_pack", lambda: kernels_quant_pack(table, g)),
            ("selective_scan", lambda: kernels_selective_scan(table, g)),
            ("selective_scan_bwd", lambda: kernels_selective_scan_bwd(table)),
            ("dense shapes", lambda: kernels_dense_shapes(table)),
            ("encdec shapes", lambda: kernels_encdec_shapes(table)),
            ("moe shapes", lambda: kernels_moe_shapes(table)),
            ("continuous shapes", lambda: kernels_continuous_shapes(table)),
            ("hybrid shapes", lambda: kernels_hybrid_shapes(table)),
            ("mla shapes", lambda: kernels_mla_shapes(table))):
        with walls(name):
            fn()
    walls.report()


def check_w4a16(table: KernelTable, g, m: int, k: int, n: int, dt,
                gs: int) -> None:
    """w4a16_matmul against its plain version on seeded weights (n, k) and
    x (m, k) in ``dt``: fp32 at 1e-5 of the largest output, bf16 at one
    bf16 ulp, a split-k launch bitwise repeatable; timed from a CUDA graph
    over weight copies beyond L2, bf16 beside the library's
    ``_weight_int4pack_mm`` and added to ``table``."""
    import torch
    from repro_torch.core.quant import compute_qparams, pack_int4, \
        quantize_codes
    from repro_torch.kernels import ops, ref, work
    dev = torch.device("cuda")
    w = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
    qp = compute_qparams(w, 4, gs)
    packed = pack_int4(quantize_codes(w, qp, 4, gs))
    x = torch.randn((m, k), generator=g, device=dev).to(dt)
    want, pms = once_ms(lambda: ref.w4a16_matmul(x, packed, qp.scales,
                                                 qp.zeros, gs))
    got = ops.w4a16_matmul_cuda(x, packed, qp.scales, qp.zeros, gs)
    # a split-K launch sums its partials in split order: a second launch on
    # the same inputs is bitwise the same
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
    wk = work.w4a16_matmul(m, n, k, gs, 2 if dt == torch.bfloat16 else 4)
    nbytes = wk.nbytes
    # distinct weight copies, 100 MB in all: each call reads its weights
    # from device memory, not from L2
    copies = [(packed, qp.scales, qp.zeros)] + [
        (packed.clone(), qp.scales.clone(), qp.zeros.clone())
        for _ in range(min(255, int(100e6 // nbytes)))]
    ms = graph_ms([(lambda c=c: ops.w4a16_matmul_cuda(x, *c, gs))
                   for c in copies])
    del copies
    lib_s = "none"
    if dt == torch.bfloat16:
        lms, lib_err = int4pack_yardstick(x, packed, qp.scales, qp.zeros,
                                          gs, want, nbytes)
        lib_s = f"{lms:.4f} ({lib_err})"
        # bf16 x runs on the tensor cores: the bf16 rate bounds it
        b_ms, by = table.add("w4a16_matmul", ms=ms, plain_ms=pms,
                             flop=wk.flop, nbytes=nbytes, err=err,
                             library_ms=lms, peak=wk.peak)
    else:
        b_ms, by = bound(wk.flop, nbytes, wk.peak)
    log(f"  w4a16_matmul m={m} k={k} n={n} {dt}: max_abs_err={err:.3e} "
        f"({tol_s}) ms={ms:.4f} plain_ms={pms:.4f} library_ms={lib_s} "
        f"bound_ms={b_ms:.4f} ({by}); k splits {splits}, two launches "
        f"bitwise equal {same}")
    check(ok and same, f"w4a16_matmul m={m} k={k} n={n} {dt}")


def check_hessian_accum(table: KernelTable, g, n_tok: int, d: int) -> None:
    """hessian_accum against its plain version on x (n_tok, d) and a
    symmetric H drawn from generator g: 1e-5 of max |H|, two launches
    bitwise equal; timed from CUDA graphs beside ``x.T @ x``."""
    import torch
    from repro_torch.kernels import ops, ref, work
    dev = torch.device("cuda")
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
    wk = work.hessian_accum(n_tok, d)
    b_ms, by = table.add("hessian_accum", ms=ms, plain_ms=pms,
                         flop=wk.flop, nbytes=wk.nbytes, err=err,
                         library_ms=lms)
    log(f"  hessian_accum n={n_tok} d={d} split "
        f"{ops.hessian_accum_geometry(n_tok, d)}: max_abs_err={err:.3e} "
        f"(tol {tol:.3e}); two launches bitwise equal {same}; "
        f"ms={ms:.4f} plain_ms={pms:.4f} library_ms(x.T@x)={lms:.4f} "
        f"bound_ms={b_ms:.4f} ({by})")
    check(err <= tol and same, f"hessian_accum n={n_tok} d={d}")


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
    from repro_torch.kernels import ops, ref, work
    w, u, hd = case["w"], case["u"], case["hd"]
    b, out_dim, in_dim = w.shape
    kw = dict(bits=4, group_size=gs, blocksize=bs, symmetric=False)
    want, pms = once_ms(lambda: ref.gptq_block(w, u, **kw))
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
    wk = work.gptq_block(b, out_dim, in_dim, gs, bs)
    timing = ""
    if table is not None:
        chol_ms = time_ms(lambda: hess.cholesky_inverse_upper(hd), 0.1, 5,
                          warm=True)
        ms = time_ms(lambda: ops.gptq_block_cuda(w, u, **kw), 0.1, 5,
                     warm=True)
        b_ms, by = table.add("gptq_block", ms=ms, plain_ms=pms,
                             flop=wk.flop, nbytes=wk.nbytes, err=err)
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
    x, w, hd, count = case["x"], case["w"], case["hd"], case["count"]
    # a stacked expert group's lanes hold fewer real rows than n
    x_count = case.get("x_count", count)
    b, out_dim, in_dim = w.shape
    hinv = _block_curvature_inv(x, hd, count, x_count, block_size=bs,
                                exact_gram=False)
    y_orig = x @ w.transpose(1, 2)
    s_full = scales.repeat_interleave(gs, dim=-1)
    z_full = zeros.repeat_interleave(gs, dim=-1)
    hinv_flat = hinv.reshape(b, in_dim, bs).contiguous()
    rargs = (w0, y_orig, x, hinv_flat, s_full, z_full)
    rkw = dict(bits=4, block_size=bs, alpha=alpha, t_max=t_max,
               symmetric=False)
    return check_rpiq_call(
        rargs, rkw, table, label, cross_gamma, cross_yq,
        curvature=lambda: _block_curvature_inv(
            x, hd, count, x_count, block_size=bs, exact_gram=False))


def check_rpiq_call(rargs: tuple, rkw: dict, table=None, label: str = "",
                    cross_gamma: bool = True, cross_yq: bool = True,
                    curvature=None) -> bool:
    """``check_rpiq`` on the kernel's own inputs ``rargs`` = (w0, y_orig,
    x, hinv_flat, s_full, z_full) and keywords ``rkw``: the kernel
    against its plain version at phase 3's pins; timed (and added to
    ``table``) where a table is given, with the stage-2 block curvature
    where ``curvature`` computes it. Returns whether the Gamma pin held."""
    from repro_torch.kernels import ops, ref, work
    w0, y_orig, x = rargs[:3]
    b, out_dim, in_dim = w0.shape
    n_tok = x.shape[1]
    bs, t_max = rkw["block_size"], rkw["t_max"]
    want_r, pms = once_ms(lambda: ref.rpiq_block(*rargs, **rkw))
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
    wk = work.rpiq_block(b, out_dim, in_dim, n_tok, bs, t_max)
    timing = ""
    if table is not None:
        ms = time_ms(lambda: ops.rpiq_block_cuda(*rargs, **rkw), 0.1, 5,
                     warm=True)
        b_ms, by = table.add("rpiq_block", ms=ms, plain_ms=pms,
                             flop=wk.flop, nbytes=wk.nbytes, err=err)
        timing = (f" ms={ms:.4f} plain_ms={pms:.4f} library_ms=none "
                  f"bound_ms={b_ms:.4f} ({by})")
        if curvature is not None:
            timing += (f"; stage-2 block curvature (library) "
                       f"ms={time_ms(curvature, 0.1, 5, warm=True):.4f}")
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
    from repro_torch.kernels import kv_codec, ops, ref, work

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
        flop, nbytes, _ = work.int8_kv_attention(b, kv, r, hd, s, nb)
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


def kernels_int8_kv_attention_ring(table: KernelTable) -> None:
    """The decode attention at h2o-danube-1.8b's serving shape (phase 9a:
    B 2, KV 8, R 4, hd 80, so kv_block 80, one scale block a row) on a
    4096-slot ring just past its wrap (position 4100 written, so the
    slots' positions are not in slot order), the last lane empty; then
    with the soft cap (30, queries scaled so the cap bends the scores) at
    that shape and at internlm2's (S 4096, hd 128). At phase 3's pins,
    a second launch bitwise the first; at softcap 0 the call is bitwise
    the call without the argument. Timed in bf16 from a CUDA graph over
    cache copies beyond L2; the uncapped ring row joins the kernel table
    (it is phase 9a's shape), the capped rows are printed beside it. Its
    inputs come from a generator of its own."""
    import torch
    from repro_torch.kernels import kv_codec, ops, ref, work
    from repro_torch.models.attention import cache_key_positions

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4323)
    for b, r, hd, cap in ((2, 4, 80, 0.0), (2, 4, 80, 30.0),
                          (4, 2, 128, 30.0)):
        kv, s = 8, 4096
        blk = kv_codec.default_kv_block(hd)
        nb = hd // blk
        x = torch.randn((2, b, s, kv, hd), generator=g, device=dev)
        kc, ks = kv_codec.enc_int8_blocks(x[0], blk)
        vc, vs = kv_codec.enc_int8_blocks(x[1], blk)
        pos = torch.full((b,), s + 4, device=dev)
        kpos = cache_key_positions(pos, s, s).to(torch.int32)
        kpos[-1] = -1
        q32 = torch.randn((b, kv, r, hd), generator=g, device=dev) \
            * hd ** -0.5 * (12.0 if cap else 1.0)
        cache = (kc, ks, vc, vs, kpos)
        want = ref.int8_kv_attention(q32, *cache, blk, cap)
        got = ops.int8_kv_attention_cuda(q32, *cache, blk, cap)
        err32 = float((got - want).abs().max())
        ok32 = err32 <= 1e-5 * float(want.abs().max())
        q = q32.to(torch.bfloat16)
        want = ref.int8_kv_attention(q, *cache, blk, cap)
        got = ops.int8_kv_attention_cuda(q, *cache, blk, cap)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = within_bf16_ulp(diff, want)
        zero = float(got[-1].abs().max()) == 0.0
        same = torch.equal(got, ops.int8_kv_attention_cuda(q, *cache, blk,
                                                            cap))
        if not cap:
            same = same and torch.equal(got, ops.int8_kv_attention_cuda(
                q, *cache, blk))
        # what the cap moves: the uncapped result on the same inputs
        moved = float((ref.int8_kv_attention(q32, *cache, blk)
                       - ref.int8_kv_attention(q32, *cache, blk, cap))
                      .abs().max()) if cap else 0.0
        splits, per = ops.int8_kv_attention_geometry(b, kv, s)
        flop, nbytes, _ = work.int8_kv_attention(b, kv, r, hd, s, nb)
        copies = [cache] + [tuple(t.clone() for t in cache)
                            for _ in range(int(100e6 // nbytes))]
        ms = graph_ms([(lambda c=c: ops.int8_kv_attention_cuda(
            q, *c, blk, cap)) for c in copies])
        pms = graph_ms([(lambda c=c: ref.int8_kv_attention(q, *c, blk, cap))
                        for c in copies])
        del copies
        if cap:
            b_ms, by = bound(flop, nbytes)
        else:
            b_ms, by = table.add("int8_kv_attention", ms=ms, plain_ms=pms,
                                 flop=flop, nbytes=nbytes, err=err)
        log(f"  int8_kv_attention B={b} S={s} KV={kv} R={r} hd={hd} "
            f"kv_block={blk}, ring after position {s + 4}, softcap {cap}: "
            f"{splits} history ranges of {per} tiles; fp32 max_abs_err="
            f"{err32:.3e} (tol 1e-5 rel) bf16 max_abs_err={err:.3e} (1 bf16 "
            f"ulp); the cap moves the result by {moved:.3e}; lane with no "
            f"valid slot is 0: {zero}; two launches bitwise equal {same}; "
            f"ms={ms:.4f} plain_ms={pms:.4f} library_ms=none bound_ms="
            f"{b_ms:.4f} ({by})")
        check(ok32 and ok and zero and same and (moved > 0) == (cap > 0),
              f"int8_kv_attention ring hd={hd} softcap={cap}")


def kernels_quant_pack(table: KernelTable, g) -> None:
    """The int4 packer at internlm2's widest shapes and falcon-mamba's four
    (in, x, dt, out), fp32 weights as pack_for_serving gives them, half the
    cells exactly on a .5 tie of w / s; bitwise against the plain version
    and the older packer, and the same weights in bf16 bitwise against the
    plain version."""
    for n, k in ((2048, 8192), (8192, 2048), (16384, 4096), (288, 8192),
                 (8192, 256), (4096, 8192)):
        check_quant_pack(table, g, n, k)


def check_quant_pack(table: KernelTable, g, n: int, k: int,
                     gs: int = 128) -> None:
    """quant_pack against its plain version on (n, k) fp32 weights drawn
    from g, half the cells exactly on a .5 tie of w / s: bitwise, the plain
    version bitwise the older packer, bf16 weights bitwise; timed from a
    CUDA graph over copies beyond L2 and added to ``table``."""
    import torch
    from repro_torch.core.quant import QuantParams, pack_int4, \
        quantize_codes
    from repro_torch.kernels import ops, ref, work

    dev = torch.device("cuda")
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
    older = pack_int4(quantize_codes(w, QuantParams(scales, zeros), 4, gs))
    n_diff = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    same = n_diff == 0 and torch.equal(want, older)
    wk = work.quant_pack(n, k, gs)
    nbytes = wk.nbytes
    args = (w, scales, zeros)
    copies = [args] + [tuple(t.clone() for t in args)
                       for _ in range(int(100e6 // nbytes))]
    ms = graph_ms([(lambda c=c: ops.quant_pack_cuda(*c, gs))
                   for c in copies])
    pms = graph_ms([(lambda c=c: ref.quant_pack(*c, gs)) for c in copies])
    del copies
    b_ms, by = table.add("quant_pack", ms=ms, plain_ms=pms,
                         flop=wk.flop, nbytes=nbytes, err=err)
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


def kernels_dense_shapes(table: KernelTable) -> None:
    """Phase 9's shapes, each kernel against its plain version at phase
    3's pins and timed into the kernel table, from a generator of its
    own: h2o-danube-1.8b (d 2560, q/o 2560 x 2560, k/v 640 x 2560, d_ff
    6912) and pixtral-12b (d 5120, q 4096 x 5120, k/v 1024 x 5120, o 5120
    x 4096, d_ff 14336). ``hessian_accum`` at d 2560, 6912, 5120 and
    14336 (n 512); bf16 ``w4a16_matmul`` at every new (k, n) at decode m 2
    (two requests) and prefill m 2048; ``gptq_block`` and ``rpiq_block``
    at the nine groups the planner forms (n 512); ``quant_pack`` at the
    nine weight shapes. At these groups ``rpiq_block``'s Gamma against the
    plain version's is reported, not held, as at 288 rows in
    ``kernels_rpiq_seeds``: at (1, 2560, 6912) the two sides' iterates,
    which the cell and Y_q pins hold, drift apart in an intermediate round
    by about the width of that pin, while each side's Gamma is held to
    1e-6 of its own iterate's exact Gamma."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(4324)
    for d in (2560, 6912, 5120, 14336):
        check_hessian_accum(table, g, 512, d)
    kn = ((2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
          (5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336),
          (14336, 5120))
    for m in (2, 2048):
        for k, n in kn:
            check_w4a16(table, g, m, k, n, torch.bfloat16, 128)
    groups = ((2, 2560, 2560), (2, 640, 2560), (2, 6912, 2560),
              (1, 2560, 6912), (1, 4096, 5120), (2, 1024, 5120),
              (1, 5120, 4096), (2, 14336, 5120), (1, 5120, 14336))
    held = 0
    for b, out_dim, in_dim in groups:
        case = group_case(g, b, out_dim, in_dim, 512)
        w0, scales, zeros = check_gptq(case, 128, 128, table)
        held += check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table,
                           cross_gamma=False)
        del case
    log(f"  rpiq_block at phase 9's groups: the kernel's Gamma within its "
        f"pin of the plain version's at {held} of {len(groups)}")
    for k, n in kn:
        check_quant_pack(table, g, n, k)


def kv_attention_row(table, g, b: int, kv: int, r: int, hd: int, s: int,
                     cap: float = 0.0, label: str = "",
                     lengths=None, ring: bool = False) -> None:
    """int8_kv_attention at one decode shape (kv_block the codec's
    default for hd, a decode cache of s slots all written but for the
    last lane, which holds none; with ``lengths``, lane i holds its first
    lengths[i] slots, as the continuous engine's slotted cache does; with
    ``ring``, lane i is a ring of s slots past its wrap, position s + 37 i
    written last, about a tenth of its slots invalid), inputs from
    generator g: fp32 at 1e-5 of the largest output, bf16 at one bf16
    ulp, a second launch bitwise the first; timed in bf16 from a CUDA
    graph over cache copies beyond L2, added to ``table`` where one is
    given. The bound counts the valid slots' bytes and products."""
    import torch
    from repro_torch.kernels import kv_codec, ops, ref, work

    dev = torch.device("cuda")
    blk = kv_codec.default_kv_block(hd)
    nb = hd // blk
    x = torch.randn((2, b, s, kv, hd), generator=g, device=dev)
    kc, ks = kv_codec.enc_int8_blocks(x[0], blk)
    vc, vs = kv_codec.enc_int8_blocks(x[1], blk)
    kpos = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    if ring:
        last = s + 37 * torch.arange(b, device=dev)[:, None]
        kpos = (last - (last - kpos) % s).to(torch.int32)
        holes = torch.rand((b, s), generator=g, device=dev) < 0.1
        kpos[holes] = -1
        kpos[-1] = -1
        lengths = [int(v) for v in (kpos >= 0).sum(dim=1).tolist()]
    if lengths is None:
        lengths = [s] * (b - 1) + [0]
    if not ring:
        for i, n in enumerate(lengths):
            kpos[i, n:] = -1
    valid = sum(lengths)
    q32 = torch.randn((b, kv, r, hd), generator=g, device=dev) \
        * hd ** -0.5 * (12.0 if cap else 1.0)
    cache = (kc, ks, vc, vs, kpos)
    want = ref.int8_kv_attention(q32, *cache, blk, cap)
    got = ops.int8_kv_attention_cuda(q32, *cache, blk, cap)
    err32 = float((got - want).abs().max())
    ok32 = err32 <= 1e-5 * float(want.abs().max())
    q = q32.to(torch.bfloat16)
    want, pms = once_ms(lambda: ref.int8_kv_attention(q, *cache, blk, cap))
    got = ops.int8_kv_attention_cuda(q, *cache, blk, cap)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = within_bf16_ulp(diff, want)
    zero = all(float(got[i].abs().max()) == 0.0
               for i, n in enumerate(lengths) if n == 0)
    same = torch.equal(got, ops.int8_kv_attention_cuda(q, *cache, blk, cap))
    splits, per = ops.int8_kv_attention_geometry(b, kv, s)
    flop, nbytes, _ = work.int8_kv_attention(b, kv, r, hd, s, nb, valid)
    # at most 255 copies, as w4a16_matmul's: a cache of a few KB (minicpm
    # smoke's) made ~33,000 copies and a 28 s graph
    copies = [cache] + [tuple(t.clone() for t in cache)
                        for _ in range(min(255, int(100e6 // nbytes)))]
    ms = graph_ms([(lambda c=c: ops.int8_kv_attention_cuda(q, *c, blk, cap))
                   for c in copies])
    del copies
    if table is not None:
        b_ms, by = table.add("int8_kv_attention", ms=ms, plain_ms=pms,
                             flop=flop, nbytes=nbytes, err=err)
    else:
        b_ms, by = bound(flop, nbytes)
    log(f"  int8_kv_attention{label} B={b} S={s} KV={kv} R={r} hd={hd} "
        f"kv_block={blk} softcap {cap}: valid slots per lane {lengths}; "
        f"{splits} history ranges of {per} "
        f"tiles; fp32 max_abs_err={err32:.3e} (tol 1e-5 rel) bf16 "
        f"max_abs_err={err:.3e} (1 bf16 ulp); lanes with no valid slot are "
        f"0: {zero}; two launches bitwise equal {same}; ms={ms:.4f} "
        f"plain_ms={pms:.4f} library_ms=none bound_ms={b_ms:.4f} ({by})")
    check(ok32 and ok and zero and same,
          f"int8_kv_attention{label} hd={hd} S={s} softcap={cap}")


def kernels_continuous_shapes(table: KernelTable) -> None:
    """Phase 12's shapes (internlm2-1.8b under the continuous engine, 8
    lanes, prefill chunks of 128, a 1024-slot int8 cache):
    ``int8_kv_attention`` at B 8 over a slotted cache whose lanes hold
    mixed lengths, two of them one slot (an empty lane decodes at position
    0) and one none; bf16 ``w4a16_matmul`` at each internlm2 (k, n) at m 8
    (the tick) and m 128 (a prefill chunk)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(4412)
    kv_attention_row(table, g, 8, 8, 2, 128, 1024, label=" (slotted)",
                     lengths=[977, 40, 512, 1, 300, 1, 129, 0])
    for m in (8, 128):
        for k, n in ((2048, 2048), (2048, 1024), (2048, 8192),
                     (8192, 2048)):
            check_w4a16(table, g, m, k, n, torch.bfloat16, 128)


def kernels_encdec_shapes(table: KernelTable) -> None:
    """Phase 10's shapes (whisper-large-v3: d 1280, d_ff 5120, 20 heads of
    64) and phase 4's minicpm smoke decode, each kernel against its plain
    version at phase 3's pins and timed into the kernel table, from a
    generator of its own. ``hessian_accum`` at d 1280 and 5120 over the
    encoder's n 3000 (2 clips x 1500 frames) and d 1280 over the
    decoder's n 512; bf16 ``w4a16_matmul`` at (k, n) (1280, 1280), (1280,
    5120) and (5120, 1280), at decode m 4, decoder prefill m 256 (4 x 64)
    and encoder prefill m 6000 (4 x 1500); ``gptq_block`` and
    ``rpiq_block`` at the encoder's groups (4, 1280, 1280), (1, 5120,
    1280) and (1, 1280, 5120) and the cross-attention's k / v group (2,
    1280, 1280), all at n 3000, and its q / o group (2, 1280, 1280) at n
    512 (the group key holds n); ``quant_pack`` at the three weight
    shapes; ``int8_kv_attention`` at the decoder's self-cache (B 4, KV
    20, R 1, hd 64, 64 + 32 + 1 slots) and at minicpm smoke's (B 2, KV 6,
    R 1, hd 12, 8 + 6 + 1 slots: a head width that is no multiple of 16),
    there with and without the soft cap."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(4326)
    for n_tok, d in ((3000, 1280), (3000, 5120), (512, 1280)):
        check_hessian_accum(table, g, n_tok, d)
    kn = ((1280, 1280), (1280, 5120), (5120, 1280))
    for m in (4, 256, 6000):
        for k, n in kn:
            check_w4a16(table, g, m, k, n, torch.bfloat16, 128)
    groups = ((4, 1280, 1280, 3000), (1, 5120, 1280, 3000),
              (1, 1280, 5120, 3000), (2, 1280, 1280, 3000),
              (2, 1280, 1280, 512))
    for b, out_dim, in_dim, n_tok in groups:
        case = group_case(g, b, out_dim, in_dim, n_tok)
        w0, scales, zeros = check_gptq(case, 128, 128, table)
        check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table)
        del case
    for k, n in kn:
        check_quant_pack(table, g, n, k)
    kv_attention_row(table, g, 4, 20, 1, 64, 97)
    for cap in (0.0, 30.0):
        kv_attention_row(None, g, 2, 6, 1, 12, 15, cap, " (minicpm smoke)")


def kernels_hybrid_shapes(table: KernelTable) -> None:
    """Phase 13's shapes (recurrentgemma-9b: d 4096, lru_width 4096, d_ff
    12288, 16 heads of 256 over one kv-head; calibration batches of 4 x
    512 tokens), each kernel against its plain version at phase 3's pins
    and timed into the kernel table, from a generator of its own:
    ``hessian_accum`` at d 4096 and 12288 (n 2048); bf16 ``w4a16_matmul``
    at (k, n) (4096, 4096) (the RG-LRU's in / gate / rg / ig / out and the
    local layers' q / o), (4096, 256) (their k / v: a narrow output),
    (4096, 12288) and (12288, 4096) at decode m 4; ``gptq_block`` and
    ``rpiq_block`` at the groups the planner forms, (5, 4096, 4096) (an
    RG-LRU layer's five), (2, 4096, 4096) (q / o), (2, 256, 4096) (k / v),
    (2, 12288, 4096) and (1, 4096, 12288) (the MLP), n 2048 (their Gamma
    reported, not held, as at phase 9's groups); ``quant_pack`` at the
    four weight shapes; ``int8_kv_attention`` at the local layers' decode
    (B 4, KV 1, R 16, hd 256, kv_block 128: the R-16 instantiation) on a
    2048-slot ring past its wrap with invalid slots."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(4328)
    for d in (4096, 12288):
        check_hessian_accum(table, g, 2048, d)
    kn = ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096))
    for k, n in kn:
        check_w4a16(table, g, 4, k, n, torch.bfloat16, 128)
    groups = ((5, 4096, 4096), (2, 4096, 4096), (2, 256, 4096),
              (2, 12288, 4096), (1, 4096, 12288))
    held = 0
    for b, out_dim, in_dim in groups:
        case = group_case(g, b, out_dim, in_dim, 2048)
        w0, scales, zeros = check_gptq(case, 128, 128, table)
        held += check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table,
                           cross_gamma=False)
        del case, w0, scales, zeros
        torch.cuda.empty_cache()
    log(f"  rpiq_block at phase 13's groups: the kernel's Gamma within its "
        f"pin of the plain version's at {held} of {len(groups)}")
    for k, n in kn:
        check_quant_pack(table, g, n, k)
    kv_attention_row(table, g, 4, 1, 16, 256, 2048, label=" (ring, R 16)",
                     ring=True)


def kernels_mla_shapes(table: KernelTable) -> None:
    """Phase 14's shapes (deepseek-v3-671b's dense layers: d 7168, 128
    heads, q / kv ranks 1536 / 512, nope / rope / v 128 / 64 / 128, d_ff
    18432; calibration batches of 4 x 512 tokens; decode over a latent
    cache of 4 x 545 slots), from a generator of its own:
    ``hessian_accum`` at d 512, 1536, 7168, 16384 and 18432 (n 2048);
    bf16 ``w4a16_matmul`` at (k, n) (7168, 1536) / (7168, 512) / (7168,
    64) (q_down, kv_down, k_rope: n 64 a narrow output), (1536, 24576)
    (q_up), (512, 16384) (k_up / v_up), (16384, 7168) (o), (7168, 18432)
    and (18432, 7168) (the MLP) at decode m 4, and (512, 16384) again at
    m 2180: each decode step expands the whole latent cache, B x max_len
    rows; ``gptq_block`` and ``rpiq_block`` at the groups the planner
    forms, (1, 1536, 7168), (1, 512, 7168), (1, 64, 7168), (1, 24576,
    1536), (2, 16384, 512), (1, 7168, 16384), (2, 18432, 7168) and (1,
    7168, 18432), n 2048 (Gamma reported, not held); ``quant_pack`` at the
    eight weight shapes."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(4329)
    for d in (512, 1536, 7168, 16384, 18432):
        check_hessian_accum(table, g, 2048, d)
    kn = ((7168, 1536), (7168, 512), (7168, 64), (1536, 24576),
          (512, 16384), (16384, 7168), (7168, 18432), (18432, 7168))
    for k, n in kn:
        check_w4a16(table, g, 4, k, n, torch.bfloat16, 128)
    check_w4a16(table, g, 4 * 545, 512, 16384, torch.bfloat16, 128)
    groups = ((1, 1536, 7168), (1, 512, 7168), (1, 64, 7168),
              (1, 24576, 1536), (2, 16384, 512), (1, 7168, 16384),
              (2, 18432, 7168), (1, 7168, 18432))
    held = 0
    for b, out_dim, in_dim in groups:
        case = group_case(g, b, out_dim, in_dim, 2048)
        w0, scales, zeros = check_gptq(case, 128, 128, table)
        held += check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table,
                           cross_gamma=False)
        del case, w0, scales, zeros
        torch.cuda.empty_cache()
    log(f"  rpiq_block at phase 14's groups: the kernel's Gamma within its "
        f"pin of the plain version's at {held} of {len(groups)}")
    for k, n in kn:
        check_quant_pack(table, g, n, k)


def moe_group_case(g, lanes: int, out_dim: int, in_dim: int, n_tok: int,
                   gs: int = 128, n_batches: int = 4) -> dict:
    """A stacked expert group as ``_moe_members`` hands it to the plan:
    each lane's calibration buffers of ``n_tok`` rows (C, the capacity)
    whose first routed-token rows are real and the rest zero padding, its
    Hessian summed over ``n_batches`` such buffers and counted in routed
    tokens, its last buffer the stage-2 instance with ``x_count`` the last
    batch's pre-capacity count (which may exceed C). Lanes 0 and 1 are
    starved (40 and 100 routed tokens in all, fewer than one group of
    ``gs``); the plan's lane helpers give them identity curvature with
    count n. Returns check_gptq's / check_rpiq's case."""
    import torch
    from repro_torch.core import hessian as hess
    from repro_torch.core import plan as qplan
    dev = torch.device("cuda")
    routed = torch.randint(n_tok // 2, 3 * n_tok // 2, (n_batches, lanes),
                           generator=g, device=dev)
    routed[:, 0] = 10
    routed[:, 1] = 25
    rows = torch.arange(n_tok, device=dev)[None, :, None]
    H = torch.zeros((lanes, in_dim, in_dim), device=dev)
    for bi in range(n_batches):
        x = torch.randn((lanes, n_tok, in_dim), generator=g, device=dev) \
            * (rows < routed[bi].clamp(max=n_tok)[:, None, None])
        H = torch.baddbmm(H, x.transpose(1, 2), x)
    w = torch.randn((lanes, out_dim, in_dim), generator=g, device=dev) \
        * in_dim ** -0.5
    total = routed.sum(dim=0)
    member = qplan.PlanMember(
        "mlp.w", w, hess.HessianState(H, total.to(torch.int32)), x,
        x_count=routed[-1].to(torch.int32),
        starved=(total < gs).cpu().numpy(),
        names=[f"mlp.w[{i}]" for i in range(lanes)])
    st = qplan._lane_hessians(member)
    x_count = qplan._lane_x_counts(member)
    del H, member
    hd = hess.damped(st, torch.full((lanes,), 0.01, device=dev))
    return dict(x=x, w=w, hd=hd, count=st.count, x_count=x_count,
                u=hess.cholesky_inverse_upper(hd),
                starved=int((total < gs).sum()))


def kernels_moe_shapes(table: KernelTable) -> None:
    """Phase 11's shapes (olmoe-1b-7b: d 2048, 16 heads of 128, 64 experts,
    top 8, d_ff_expert 1024; calibration batches of 4 x 512 tokens, so the
    experts' capacity C is 320 rows), each kernel against its plain version
    at phase 3's pins and timed into the kernel table, from a generator of
    its own: ``hessian_accum`` on the attention taps (n 2048, d 2048);
    ``gptq_block`` and ``rpiq_block`` at the attention group (4, 2048,
    2048) at n 2048 and at the stacked expert groups, w_gate and w_up
    sharing one of 128 lanes (128, 1024, 2048) and w_down (64, 2048,
    1024), on zero-padded capacity buffers of n 320 with per-lane
    ``x_count`` and two starved lanes (``moe_group_case``); ``quant_pack``
    at the stacked experts' (E·out, in) = (65536, 2048) and (131072,
    1024); ``int8_kv_attention`` at the decode cache (B 4, KV 16, R 1, hd
    128, 512 + 32 + 1 slots)."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda")
    g.manual_seed(4327)
    check_hessian_accum(table, g, 2048, 2048)
    case = group_case(g, 4, 2048, 2048, 2048)
    w0, scales, zeros = check_gptq(case, 128, 128, table)
    check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table)
    del case
    for lanes, out_dim, in_dim in ((128, 1024, 2048), (64, 2048, 1024)):
        case = moe_group_case(g, lanes, out_dim, in_dim, 320)
        log(f"  expert group ({lanes}, {out_dim}, {in_dim}), n 320: "
            f"{case['starved']} starved lanes; x_count "
            f"{case['x_count'].min().item()}..{case['x_count'].max().item()}"
            f"; rpiq_block cluster split "
            f"{ops.rpiq_block_geometry(lanes, out_dim, 320)}")
        w0, scales, zeros = check_gptq(case, 128, 128, table)
        check_rpiq(case, w0, scales, zeros, 128, 128, 5, 0.01, table)
        del case, w0, scales, zeros
        torch.cuda.empty_cache()
    for n, k in ((65536, 2048), (131072, 1024)):
        check_quant_pack(table, g, n, k)
    kv_attention_row(table, g, 4, 16, 1, 128, 545)


def kernels_selective_scan(table: KernelTable, g) -> None:
    """The Mamba-1 scan at falcon-mamba-7b's prefill (S 512) and
    calibration (S 128) shapes and a ragged S 77: B 4, d 8192, n 16,
    nonzero h0, dt > 0 as softplus gives it; then 17a's split training
    shape, a rank's 2048 of the 8192 channels at S 256 (from a generator
    of its own, so the sections after it draw what they drew before it
    was added). u in fp32 (y and h_last within 1e-5 of their largest
    value) and in bf16, the path's dtype (y within one bf16 ulp, h_last
    within 1e-5); timed in bf16 from a CUDA graph over input copies
    beyond the 50 MB L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work

    dev = torch.device("cuda")
    split = torch.Generator(device=dev)
    split.manual_seed(31)
    b, n = 4, 16
    for s, d, gen in ((512, 8192, g), (128, 8192, g), (77, 8192, g),
                      (SPLIT_RUN["seq"], 8192 // SPLIT_RUN["model"], split)):
        u = torch.randn((b, s, d), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, s, d), generator=gen, device=dev)
                        - 1)
        bm, cm = (torch.randn((b, s, n), generator=gen, device=dev)
                  for _ in range(2))
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=dev)).repeat(d, 1)
        d_skip = torch.randn((d,), generator=gen, device=dev)
        h0 = torch.randn((b, d, n), generator=gen, device=dev) * 0.1
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
        flop, nbytes, _ = work.selective_scan(b, s, d, n)
        timing = ""
        if s != 77:
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
        check(ok, f"selective_scan S={s} d={d}")


SCAN_GRADS = ("du", "ddt", "dB", "dC", "dA_log", "dD", "dh0")


def kernels_selective_scan_bwd(table: KernelTable) -> None:
    """The scan's backward at falcon-mamba-7b's training shapes (B 4, d
    8192, n 16; S 512 and 128), a ragged S 77 and 17a's split shape (d
    2048, S 256), nonzero h0, dy and dh_last, u (and dy) in fp32 and in
    bf16: every gradient within 1e-5 of its largest magnitude of
    ``ref.selective_scan_backward`` on the same inputs, bf16 du within
    one bf16 ulp; a second launch bitwise the first. Timed in bf16 but at
    S 77 (CUDA events; the plain version's time is its check's one call).
    Its inputs come from a generator of its own, so the sections after it
    draw what they drew before it was added."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, work

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    b, n = 4, 16
    for s, d in ((512, 8192), (128, 8192), (77, 8192),
                 (SPLIT_RUN["seq"], 8192 // SPLIT_RUN["model"])):
        u = torch.randn((b, s, d), generator=g, device=dev)
        dt = F.softplus(torch.randn((b, s, d), generator=g, device=dev) - 1)
        bm, cm = (torch.randn((b, s, n), generator=g, device=dev)
                  for _ in range(2))
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=dev)).repeat(d, 1)
        d_skip = torch.randn((d,), generator=g, device=dev)
        h0 = torch.randn((b, d, n), generator=g, device=dev) * 0.1
        dy = torch.randn((b, s, d), generator=g, device=dev)
        dh_last = torch.randn((b, d, n), generator=g, device=dev)
        rest = (dt, bm, cm, a_log, d_skip, h0)
        for name, udt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = (u.to(udt),) + rest + (dy.to(udt), dh_last)
            want, pms = once_ms(lambda: ref.selective_scan_backward(*args))
            got = ops.selective_scan_bwd_cuda(*args)
            again = ops.selective_scan_bwd_cuda(*args)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            rels, err, ok = {}, 0.0, same
            for key, x, w in zip(SCAN_GRADS, got, want):
                diff = (x.float() - w.float()).abs()
                err = max(err, float(diff.max()))
                rels[key] = float(diff.max()) / float(w.float().abs().max())
                if key == "du" and udt == torch.bfloat16:
                    rels[key] = bf16_ulps(diff, w)
                    ok = ok and rels[key] <= 1.0
                else:
                    ok = ok and rels[key] <= 1e-5
            timing = ""
            if name == "bf16" and s != 77:
                ms = time_ms(lambda: ops.selective_scan_bwd_cuda(*args))
                w = work.selective_scan_backward(b, s, d, n, 2)
                b_ms, by = table.add("selective_scan_bwd", ms=ms,
                                     plain_ms=pms, flop=w.flop,
                                     nbytes=w.nbytes, err=err)
                scratch = work.selective_scan_backward_scratch(b, s, d)
                timing = (f" ms={ms:.4f} plain_ms={pms:.4f} library_ms=none"
                          f" bound_ms={b_ms:.4f} ({by}); scratch {scratch} "
                          f"bytes (with it, the bytes bound "
                          f"{(w.nbytes + 2 * scratch) / H100_BYTES * 1e3:.4f}"
                          " ms)")
            log(f"  selective_scan_bwd B={b} S={s} d={d} n={n} u {name}: "
                + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
                + f" (rel to the largest; bf16 du in ulps; tol 1e-5, 1 ulp);"
                f" two launches bitwise {same}{timing}")
            check(ok, f"selective_scan_bwd S={s} d={d} u {name}")
            del want, got, again


def with_frontend(mc, batch: dict, seed: int, device="cpu") -> dict:
    """``batch`` with ``mc.frontend_tokens`` seeded standard-normal patch
    embeddings (B, F, d_model) added, for a model with a frontend."""
    import torch
    if mc.frontend_tokens:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        batch["embeds"] = torch.randn(
            (batch["tokens"].shape[0], mc.frontend_tokens, mc.d_model),
            generator=gen, device=device)
    return batch


def phase_small_end_to_end(arch: str, kv_cache: str) -> None:
    """A smoke config in fp32: the card's run against the CPU plain run
    (pixtral's calibration batches and requests with their patch
    embeddings)."""
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
    mc = cfg.model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cpu")
    calib = [with_frontend(mc, b, 20 + i) for i, b in enumerate(
        calibration_batches(MarkovLM(mc.vocab_size, seed=7), 3, 4, 32))]
    prompt = with_frontend(mc, MarkovLM(mc.vocab_size, seed=3).batch(2, 8),
                           30)
    runs = {}
    for dev in ("cpu", "cuda"):
        pq, rep = quantize_model(cfg, params, calib, device=dev)
        pk = pack_for_serving(cfg, pq)
        last = calib[-1]["tokens"].to(dev)
        logits, hid = T.forward_hidden(mc, pk, last, calib[-1].get("embeds"))
        # deepseek's MTP head on the packed model (its layer RTN-packed)
        mtp = (T.mtp_logits(mc, pk, hid, last).cpu() if mc.mtp_depth
               else None)
        toks = generate(cfg, pk, prompt, device=dev, max_new_tokens=6)
        runs[dev] = (rep, pk, logits.cpu(), toks.tokens.cpu(), mtp)
    (rc, pc, lc, tc, mc_), (rg, pg, lg, tg, mg) = runs["cpu"], runs["cuda"]
    modes = all(a.mode == b.mode and a.iters == b.iters
                for a, b in zip(rc.linears, rg.linears))
    lin_c, lin_g = (dict(quantized_leaves(p["layers"])) for p in (pc, pg))
    codes = [(qt.packed, lin_g[k].packed) for k, qt in lin_c.items()]
    same_set = list(lin_c) == list(lin_g) and len(codes) > 0
    mism = sum(int((a != b.cpu()).sum()) for a, b in codes) / sum(
        a.numel() for a, _ in codes)
    rel = float((lg - lc).norm() / lc.norm())
    # routed experts compute in bf16 at any model dtype (as in the
    # reference): an expert product one fp32 rounding apart may round to
    # the neighbouring bf16 value, 3.9e-3 of it
    tol = 1e-2 if mc.moe.num_experts else 1e-3
    rel_mtp = (float((mg - mc_).norm() / mc_.norm()) if mc.mtp_depth
               else 0.0)
    log(f"  {cfg.model.name} fp32 kv_cache={kv_cache}, card vs CPU plain: "
        f"modes/iters equal {modes}; the same {len(codes)} packed linears "
        f"{same_set}; packed-byte mismatch {mism:.2e} (tol "
        f"1e-2); packed logits rel {rel:.2e} (tol {tol:.0e}); greedy tokens "
        f"equal {bool(torch.equal(tc, tg))}"
        + (f"; mtp_logits rel {rel_mtp:.2e} (tol {tol:.0e})"
           if mc.mtp_depth else ""))
    check(modes and same_set and mism <= 1e-2 and rel <= tol
          and rel_mtp <= tol and torch.equal(tc, tg),
          f"small end to end {arch} kv_cache={kv_cache}, card against CPU "
          "plain")


def phase_small_bf16(arch: str, kv_cache: str) -> None:
    """A smoke config at its own dtype (bf16) and group size (opt-proxy
    16, the others 8) on the card: quantize → pack →
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
    calib = [with_frontend(mc, b, 20 + i) for i, b in enumerate(
        calibration_batches(MarkovLM(mc.vocab_size, seed=7), 3, 4, 32))]
    n_req, n_prompt = 2, 8
    prompt = with_frontend(mc, MarkovLM(mc.vocab_size, seed=3).batch(
        n_req, n_prompt), 30)
    pq, rep = quantize_model(cfg, params, calib, device="cuda")
    pk = pack_for_serving(cfg, pq)
    toks = generate(cfg, pk, prompt, device="cuda", max_new_tokens=6)
    n_quant = sum(1 for rec in rep.linears if rec.mode != "skipped")
    h = T.embed_inputs(mc, pk, prompt["tokens"].cuda(), prompt.get("embeds"))
    calls = []
    with paired_route(calls):
        h = T.layer_forward(mc, T.layer_specs(mc)[0], pk["layers"][0], h,
                            T.positions_for(n_req, h.shape[1], "cuda"))
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


# phase 4's naive-attention legs (``model.opt_attention=false``): a GQA
# family on its bf16 cache, the encoder-decoder (cross-attention)
NAIVE_LEGS = ("internlm2-1.8b", "whisper-large-v3")


def phase_small_naive(arch: str) -> None:
    """A smoke config under ``model.opt_attention=false`` (the reference's
    naive attention: fp32 queries, products and probabilities, the
    head-repeated bf16 cache materialized in fp32 at decode) on float
    seeded weights, card against CPU: in fp32 compute the prefill logits
    (1e-4) and generate's greedy tokens (6 new, the card's decode a
    replayed graph) equal; in bf16 compute the prefill logits (1e-2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, tree_to_numpy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate, prefill

    t0 = time.perf_counter()
    out = []
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
        cfg = get_config(arch, smoke=True)
        cfg.model.opt_attention = False
        cfg.model.dtype = dtype
        mc = cfg.model
        gen = torch.Generator()
        gen.manual_seed(0)
        params = (T.init_encdec_params if mc.is_encoder_decoder
                  else T.init_params)(mc, gen, "cpu")
        reqs = [r for r, _ in small_requests(mc, [(8, 6), (8, 6)], 3)]
        batch = {k: torch.cat([r[k] for r in reqs]) for k in reqs[0]}
        runs = {}
        for dev in ("cpu", "cuda"):
            p = params_from_numpy(tree_to_numpy(params), dev)
            on = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                logits, _ = prefill(cfg, p, on, 8 + 7)
                toks = generate(cfg, p, on, device=dev, max_new_tokens=6)
            runs[dev] = (logits.float().cpu(), toks.tokens.cpu())
        (lc, tc), (lg, tg) = runs["cpu"], runs["cuda"]
        rel = float((lg - lc).norm() / lc.norm())
        same = bool(torch.equal(tc, tg))
        out.append(f"{dtype} prefill logits rel {rel:.2e} (tol {tol:.0e}),"
                   f" greedy tokens equal {same}")
        check(rel <= tol and (same or dtype == "bfloat16"),
              f"naive attention {arch} {dtype}, card against CPU")
    log(f"  {arch} smoke, model.opt_attention=false, card against CPU: "
        + "; ".join(out) + f" ({time.perf_counter() - t0:.1f}s)")


def small_requests(mc, shapes, seed: int) -> list:
    """Batch-1 requests of the given (prompt length, budget) shapes from
    ``MarkovLM(vocab, seed)``, with seeded frames for an encoder-decoder
    and patch embeddings for a model with a frontend."""
    import torch
    from repro_torch.data import MarkovLM
    data = MarkovLM(mc.vocab_size, seed=seed)
    out = []
    for i, (n, m) in enumerate(shapes):
        b = data.batch(1, n)
        if mc.is_encoder_decoder:
            gen = torch.Generator()
            gen.manual_seed(seed + i)
            b["frames"] = torch.randn((1, mc.encoder_seq_len, mc.d_model),
                                      generator=gen)
        else:
            b = with_frontend(mc, b, seed + i)
        out.append((b, m))
    return out


def phase_small_serving(arch: str, kv_cache: str) -> None:
    """A smoke config in fp32, card against the CPU plain run: the
    chunked prefill (chunks of 3) of two prompts of 9; a continuous run
    (2 lanes, chunk 3, 3 requests, the card's ticks replaying its graph)
    on the RTN-packed weights; the guardrail ladder with
    ``hessian.cholesky@1:nonpsd`` and ``@1:nan`` armed (calibration 2 x 2
    x 16): the same ``guardrail_stats`` and record modes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, tree_to_numpy
    from repro_torch.core import faults
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import ContinuousEngine

    cfg = get_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    cfg.serve.kv_cache = kv_cache
    cfg.serve.max_batch, cfg.serve.prefill_chunk = 2, 3
    mc = cfg.model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = (T.init_encdec_params if mc.is_encoder_decoder
              else T.init_params)(mc, gen, "cpu")
    batch = dict(small_requests(mc, [(9, 0)], 40)[0][0])
    batch = {k: torch.cat([v, v.flip(1)]) for k, v in batch.items()}
    reqs = small_requests(mc, [(5, 4), (9, 6), (7, 3)], 50)
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 2, 2, 16)
    for i, b in enumerate(calib):
        if mc.is_encoder_decoder:
            gen.manual_seed(60 + i)
            b["frames"] = torch.randn((2, mc.encoder_seq_len, mc.d_model),
                                      generator=gen)
        else:
            with_frontend(mc, b, 60 + i)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = params_from_numpy(tree_to_numpy(params), dev)
        pk = pack_for_serving(cfg, p)
        inputs = {k: v.to(dev) for k, v in batch.items()}
        n_front = inputs["embeds"].shape[1] if "embeds" in inputs else 0
        logits, _ = engine.prefill(cfg, pk, inputs, 9 + n_front + 8)
        eng = ContinuousEngine(cfg, pk, max_len=32, device=dev)
        rids = [eng.submit(b, max_new_tokens=m) for b, m in reqs]
        done = eng.run()
        ladder = []
        for spec in ("hessian.cholesky@1:nonpsd", "hessian.cholesky@1:nan"):
            with faults.inject(spec):
                _, rep = quantize_model(cfg, p, calib, device=dev)
            ladder.append((dict(rep.guardrail_stats),
                           [r.mode for r in rep.linears]))
        runs[dev] = (logits.cpu(), [(done[r].tokens.tolist(), done[r].status)
                                    for r in rids], ladder,
                     eng._graph is not None)
    (lc, tc, gc, _), (lg, tg, gg, replayed) = runs["cpu"], runs["cuda"]
    rel = float((lg - lc).norm() / lc.norm())
    tol = 1e-2 if mc.moe.num_experts else 1e-3
    stats = [g[0] for g in gg]
    log(f"  {mc.name} fp32 kv_cache={kv_cache}, card vs CPU plain: chunked "
        f"prefill logits rel {rel:.2e} (tol {tol:.0e}); continuous run "
        f"tokens and statuses equal {tc == tg} (card ticks replayed a "
        f"graph: {replayed}); ladder stats and modes equal {gc == gg} "
        f"({stats})")
    check(rel <= tol and tc == tg and replayed and gc == gg
          and all(st == "ok" for _, st in tg)
          and stats[0]["lanes_damp_recovered"] == 1
          and stats[1]["lanes_rtn_forced"] == 1,
          f"small serving and ladder {arch} kv_cache={kv_cache}, card "
          "against CPU plain")


def phase_small_starved() -> None:
    """olmoe smoke in fp32 on a calibration too short for every expert (2
    batches x 2 x 16 tokens: 128 routed assignments over 8 experts, group
    8),
    card against the CPU plain run: the same lanes fall back to RTN
    (``"rtn-fallback"``), the same capacity drops, and each RTN lane's
    packed codes, scales and zeros bitwise the CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe-1b-7b", smoke=True)
    cfg.model.dtype = "float32"
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, "cpu")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7), 2, 2,
                                16)
    runs = {}
    for dev in ("cpu", "cuda"):
        pq, rep = quantize_model(cfg, params, calib, device=dev)
        runs[dev] = (rep, pack_for_serving(cfg, pq))
    (rc, pc), (rg, pg) = runs["cpu"], runs["cuda"]
    rtn = [(i, r.name) for i, r in enumerate(rc.linears)
           if r.mode == "rtn-fallback"]
    same_modes = [r.mode for r in rc.linears] == [r.mode for r in rg.linears]
    per_layer = len(rc.linears) // len(pc["layers"])
    n_equal = 0
    for i, name in rtn:
        w, e = name[len("mlp."):-1].split("[")     # "mlp.w_up[3]"
        a = pc["layers"][i // per_layer]["mlp"][w]
        b = pg["layers"][i // per_layer]["mlp"][w]
        e = int(e)
        n_equal += int(torch.equal(a.packed[e], b.packed[e].cpu())
                       and torch.equal(a.scales[e], b.scales[e].cpu())
                       and torch.equal(a.zeros[e], b.zeros[e].cpu()))
    log(f"  {cfg.model.name} fp32 on 2 x 2 x 16 calibration tokens, card vs "
        f"CPU plain: {len(rtn)} RTN lanes of {len(rc.linears)} records; "
        f"modes equal {same_modes}; capacity drops card "
        f"{rg.moe_capacity_dropped} CPU {rc.moe_capacity_dropped}; RTN "
        f"lanes bitwise the CPU's (codes, scales, zeros): {n_equal} of "
        f"{len(rtn)}")
    check(len(rtn) > 0 and same_modes and n_equal == len(rtn)
          and rg.moe_capacity_dropped == rc.moe_capacity_dropped,
          "olmoe smoke starved experts, card against CPU plain")


def _nbytes_bf16_vs_int4(pk) -> tuple:
    from repro_torch.core.quant import quantized_leaves
    bf16 = int4 = 0
    for _, w in quantized_leaves(pk["layers"]):
        bf16 += 2 * math.prod(w.shape)
        int4 += w.packed.numel() + 4 * w.scales.numel() + 4 * w.zeros.numel()
    return bf16, int4


# phase 15 holds the overlap schedule against the serial runs of phases 6
# and 11: each one's leaf digests, report, walls and quantization peak
SERIAL_RUNS: dict = {}
# phase 17a holds the sharded opt-proxy run against phase 5's: its
# quantized leaves on the host and its records' names and modes
MAIN_RUN: dict = {}


def host_leaves(tree) -> dict:
    """{path: tensor on the host} of a (quantized float) param tree."""
    from repro_torch.distributed.checkpoint import tree_paths
    return {k: v.detach().cpu() for k, v in tree_paths(tree)
            if hasattr(v, "detach")}


def leaf_digests(tree) -> list:
    """The sha256 of every tensor of a (packed) tree, with its dtype and
    shape, in ``tensors_of``'s order, read on the host."""
    import hashlib
    import torch
    out = []
    for t in tensors_of(tree):
        a = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(memoryview(a.numpy()))
        out.append(h.hexdigest())
    return out


def report_digest(report) -> tuple:
    """What two schedules' reports must share: each record's name, mode,
    iterations and Γ history, and the capacity drops."""
    return ([(r.name, r.mode, r.iters, r.gamma, r.gamma_final)
             for r in report.linears], dict(report.moe_capacity_dropped))


def keep_serial(arch: str, r: dict) -> None:
    """Keep what phase 15 compares of a serial ``drive_main_path`` run."""
    rep = r["report"]
    SERIAL_RUNS[arch] = dict(leaves=leaf_digests(r["packed"]),
                             report=report_digest(rep), wall=r["quantize_s"],
                             steps=sum(rep.layer_step_seconds),
                             peak=r["quantize_peak"])


def drive_main_path(arch: str, kv_cache: str, n_req: int, n_prompt: int,
                    n_new: int, layers: int = 0,
                    calib_shape: tuple = (4, 4, 128)) -> dict:
    """A config at full width from seeded random weights, at full depth
    unless ``layers`` cuts it: quantize_model → pack_for_serving →
    generate, with the launch counters reset just before and read just
    after; calibration ``MarkovLM(vocab, seed=7)`` batches x rows x tokens
    (``calib_shape``), a model with a frontend getting its patch
    embeddings (seeded ``torch.randn`` on the card) in every calibration
    batch and request. Prints the counters, walls, bytes and peak memory
    and returns what the checks need, with ``starts`` the first decode
    position of generate's lanes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    from repro_torch.serving.engine import generate

    cfg = get_config(arch)
    cfg.serve.kv_cache = kv_cache
    mc, qc = cfg.model, cfg.quant
    full_depth = mc.num_layers
    if layers:
        mc.num_layers = layers
    if "mamba" in mc.layer_kinds:
        widths = (f"kinds={mc.block_pattern} d_inner="
                  f"{mc.ssm.expand * mc.d_model} d_state={mc.ssm.d_state} "
                  f"d_conv={mc.ssm.d_conv} dt_rank={mc.ssm.dt_rank}")
    else:
        widths = (f"heads={mc.num_heads} kv_heads={mc.num_kv_heads} "
                  f"head_dim={mc.head_dim} d_ff={mc.d_ff}")
        if mc.window_size:
            widths += f" window={mc.window_size} kinds={mc.block_pattern}"
        if mc.frontend_tokens:
            widths += (f" frontend={mc.frontend} "
                       f"x {mc.frontend_tokens} patch embeddings")
        if mc.moe.num_experts:
            widths += (f" experts={mc.moe.num_experts} top_k="
                       f"{mc.moe.top_k} d_ff_expert={mc.moe.d_ff_expert} "
                       f"capacity_factor={mc.moe.capacity_factor} "
                       f"first_dense_layers={mc.moe.first_dense_layers}")
        if mc.rglru.enabled:
            widths += (f" lru_width={mc.rglru.lru_width} conv1d_width="
                       f"{mc.rglru.conv1d_width} logits_softcap="
                       f"{mc.logits_softcap} tied={mc.tie_embeddings}")
        if mc.mla.enabled:
            m = mc.mla
            widths += (f" mla q/kv ranks {m.q_lora_rank}/{m.kv_lora_rank} "
                       f"nope/rope/v {m.qk_nope_head_dim}/"
                       f"{m.qk_rope_head_dim}/{m.v_head_dim} "
                       f"mtp_depth={mc.mtp_depth}")
    depth = (f"depth cut to {mc.num_layers} of {full_depth}" if layers
             else "depth not cut")
    log(f"  config: {mc.name} layers={mc.num_layers} d_model={mc.d_model} "
        f"{widths} vocab={mc.vocab_size} "
        f"dtype={mc.dtype}; quant group={qc.group_size} "
        f"blocksize={qc.blocksize} rpiq_iters={qc.rpiq_iters}; serve "
        f"kv_cache={kv_cache} ({depth}); calibration {calib_shape[0]} "
        f"batches x {calib_shape[1]} x {calib_shape[2]} tokens; "
        f"{n_req} requests x {n_prompt} prompt tokens + {n_new} new")
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cuda")
    calib = [with_frontend(mc, b, 20 + i, "cuda") for i, b in enumerate(
        calibration_batches(MarkovLM(mc.vocab_size, seed=7), *calib_shape))]
    prompt = with_frontend(mc, MarkovLM(mc.vocab_size, seed=3).batch(
        n_req, n_prompt), 30, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    params_q, report = quantize_model(cfg, params, calib)
    t1 = time.perf_counter()
    quantize_peak = torch.cuda.max_memory_allocated() - held_before
    del params          # the original float layers: no longer needed
    packed = pack_for_serving(cfg, params_q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before_gen = ops.kernel_launches()
    starts, pre = [], []
    with patched(engine, "DecodeLoop", recording_starts(starts)), \
            patched(engine, "prefill", timed(pre)):
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
        f"{n_prompt} prompt + {n_new} new tokens; its prefill "
        f"{pre[0]:.4f}, its decode step's graph capture "
        f"{res.capture_s:.4f}); decode started at positions {starts[0]}")
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
                prompt=prompt, res=res, launches=launches, report=report,
                starts=starts, quantize_s=t1 - t0,
                quantize_peak=quantize_peak)


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

    inputs = {k: v.cuda() for k, v in prompt.items()}
    # decode starts after the tokens and any embeds in front of them (an
    # encoder-decoder's frames feed its encoder)
    s0 = sum(inputs[k].shape[1] for k in ("tokens", "embeds") if k in inputs)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def fresh_loop():
        lg, caches = engine.prefill(cfg, packed, inputs, s0 + n_new + 1)
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
    MAIN_RUN.update(q=host_leaves(r["params_q"]),
                    leaves=leaf_digests(r["params_q"]),
                    records=[(x.name, x.mode) for x in r["report"].linears])
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
    keep_serial("internlm2-1.8b", r)
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
    check_path_launches(launches, "int8-KV path", ("selective_scan",))
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

    int8_drift(mc, packed, prompt["tokens"].cuda())

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


def int8_drift(mc, packed, ptoks, n_steps: int = 16) -> None:
    """The int8 and the bf16 cache fed the same (bf16-chosen) stream of
    ``n_steps`` decode steps after a prefill of ``ptoks``: the largest
    logit difference a step must not accumulate (late <= 3 x early +
    0.05); prints the prefill and step walls of both caches."""
    import torch
    from repro_torch.models import transformer as T

    n_req, n_prompt = ptoks.shape

    def timed_prefill(dt):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = T.prefill(mc, packed, ptoks, n_prompt + n_steps + 1,
                        cache_dtype=dt)
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
    for _ in range(n_steps):
        out = {}
        for kind in ("bf16", "int8"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[kind], caches[kind] = T.decode_step(mc, packed, tok, pos,
                                                    caches[kind])
            torch.cuda.synchronize()
            step[kind] += (time.perf_counter() - t) / n_steps
        deltas.append(float((out["bf16"] - out["int8"]).abs().max()))
        scale = max(scale, float(out["bf16"].abs().max()))
        tok = torch.argmax(out["bf16"], -1)
        pos = pos + 1
    half = n_steps // 2
    early, late = max(deltas[:half]), max(deltas[half:])
    log(f"  walls (s): prefill bf16 cache {walls['prefill bf16']:.3f}, "
        f"int8 cache {walls['prefill int8']:.3f}; decode step bf16 cache "
        f"{step['bf16']:.4f}, int8 cache {step['int8']:.4f} (mean of "
        f"{n_steps})")
    log(f"  drift int8 vs bf16 cache over {n_steps} steps: max |dlogit| per "
        f"step {[round(d, 4) for d in deltas]}; max {max(deltas):.4f} = "
        f"{max(deltas) / scale:.3e} of max |logit| {scale:.3f}; late "
        f"{late:.4f} <= 3 x early {early:.4f} + 0.05: "
        f"{late <= 3 * early + 0.05}")
    check(late <= 3 * early + 0.05, "int8 KV drift does not accumulate")


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


# the depths of phases 7, 9a, 10 and 13, cut so that the whole script, with
# phase 16's training and 17a's split legs, stays inside its 1200 s (each
# phase's wall at full depth is in PERF.md §6; 10 and 13 halved when 17a
# gained recurrentgemma and deepseek)
MAMBA_LAYERS = 8         # of falcon-mamba-7b's 64
RING_LAYERS = 4          # of h2o-danube-1.8b's 24
ENCDEC_LAYERS = 4        # of whisper-large-v3's 32 encoder and 32 decoder
HYBRID_LAYERS = 3        # of recurrentgemma-9b's 38: one whole period


def phase_mamba_path() -> dict:
    """falcon-mamba-7b at full width, cut to ``MAMBA_LAYERS`` layers: the
    launch counts (the
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
    r = drive_main_path("falcon-mamba-7b", "fp16", n_req, n_prompt, n_new,
                        layers=MAMBA_LAYERS)
    cfg, params_q, packed = r["cfg"], r["params_q"], r["packed"]
    launches, res, prompt = r["launches"], r["res"], r["prompt"]
    mc = cfg.model
    check_path_launches(launches, "Mamba path", ("int8_kv_attention",))
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
    # the scan's (dt*u)*B, and y's sum over the states), over the layers
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


def ring_against_full(cfg, packed, prompt, tokens, n_steps: int) -> tuple:
    """In fp32 compute, prefill and ``n_steps`` decode steps fed
    ``tokens`` (B, n_steps) on the model's ring caches and on full-length
    caches that the window masks (``init_layer_cache`` patched: same
    codes, scales and values, other slots, so the two differ only in the
    order the attention sums its slots); returns (the largest relative
    error of a step's logits, the ring caches' bytes, the full-length
    caches' bytes, the ring's rows, the full-length rows)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import cache_dtype

    mc = dataclasses.replace(cfg.model, dtype="float32")
    toks = prompt["tokens"].cuda()
    b, s0 = toks.shape
    max_len = s0 + n_steps + 1
    cdt = cache_dtype(cfg)

    def run():
        lg, caches = T.prefill(mc, packed, toks, max_len, cache_dtype=cdt)
        out = []
        pos = torch.full((b,), s0, dtype=torch.long, device="cuda")
        for i in range(n_steps):
            lg, caches = T.decode_step(mc, packed, tokens[:, i], pos, caches)
            out.append(lg)
            pos = pos + 1
        return out, caches

    def nbytes(caches):
        return sum(t.numel() * t.element_size() for c in caches
                   for t in c.values())

    ring, caches = run()
    rows, ring_bytes = {c["k"].shape[1] for c in caches}, nbytes(caches)
    del caches
    with patched(T, "init_layer_cache", lambda orig: (
            lambda c, spec, b_, n, dev, dt: A.init_kv_cache(c, b_, n, dev,
                                                            dt))):
        full, caches = run()
    full_rows, full_bytes = {c["k"].shape[1] for c in caches}, nbytes(caches)
    del caches
    worst = max(float((a - f).norm() / f.norm()) for a, f in zip(ring, full))
    return worst, ring_bytes, full_bytes, rows, full_rows


def phase_ring_path(smi: str) -> dict:
    """9a: h2o-danube-1.8b at full width (window 4096, head_dim 80), cut to
    ``RING_LAYERS`` of its 24 "swa" layers → quantize_model → pack_for_serving →
    generate on the int8 ring with a 4608-token prompt (the prefill keeps
    the last 4096 positions), then two more serves of 4080-token prompts
    (int8 and bf16 cache) whose decode crosses the wrap at position 4096
    inside the replayed graph. Checks: each generate's replay bitwise the
    eager loop's; each leg's first decode steps, in fp32 compute, against
    full-length caches that the window masks (every step across the
    wrap); the int8-vs-bf16 drift rule of phase 6 across the wrap; the
    ring's bytes those of min(window, max_len) rows."""
    import torch
    from repro_torch.data import MarkovLM
    from repro_torch.models import transformer as T

    n_req, n_new = 2, 32
    r = drive_main_path("h2o-danube-1.8b", "int8", n_req, 4608, n_new,
                        layers=RING_LAYERS)
    cfg, packed, launches = r["cfg"], r["packed"], r["launches"]
    del r["params_q"]
    mc = cfg.model
    w = mc.window_size
    check(r["starts"] == [[4608] * n_req], "9a: decode starts after the "
          "prompt")
    legs = [("int8", r["prompt"], r["res"])]
    for kv in ("int8", "fp16"):
        cfg.serve.kv_cache = kv
        prompt = MarkovLM(mc.vocab_size, seed=3).batch(n_req, 4080)
        counts, res = serve_leg(cfg, packed, prompt, n_new,
                                f"{kv} cache, {n_req} x 4080 prompt + "
                                f"{n_new} new (decode crosses the wrap at "
                                f"4096)", smi)
        for k, n in counts.items():
            launches[k] += n
        legs.append((kv, prompt, res))
    check_path_launches(launches, "ring path", ("selective_scan",))
    # the two int8 legs' decode steps after the first eager one
    kv_calls = 2 * mc.num_layers * (n_new - 1)
    check(launches["int8_kv_attention"] == kv_calls,
          f"int8_kv_attention launched {launches['int8_kv_attention']} "
          f"times, expected {kv_calls} (2 int8 legs x layers x decode steps)")

    for kv, prompt, res in legs:
        cfg.serve.kv_cache = kv
        s0 = prompt["tokens"].shape[1]
        steps = 2 if s0 > w else 20
        worst, nbytes, full_bytes, rows, full_rows = ring_against_full(
            cfg, packed, prompt, res.tokens[:, :steps].cuda(), steps)
        max_len = s0 + steps + 1
        log(f"  {kv} cache, prompt {s0}: {steps} decode steps in fp32 "
            f"compute, ring against full-length caches masked by the "
            f"window: largest rel err of a step's logits {worst:.3e} (tol "
            f"1e-4); rows a layer {sorted(rows)} (full-length "
            f"{sorted(full_rows)}); cache bytes ({mc.num_layers} layers, "
            f"{n_req} lanes) {nbytes} against {full_bytes} full-length "
            f"({full_bytes / nbytes:.3f}x)")
        check(worst <= 1e-4 and rows == {min(w, max_len)}
              and full_rows == {max_len} and nbytes < full_bytes,
              f"9a: ring against full-length caches, {kv} cache, prompt "
              f"{s0}")

    # drift across the wrap: the int8 and the bf16 ring fed the same
    # (bf16-chosen) stream from the 4080-token prompt, 32 steps
    ptoks = legs[1][1]["tokens"].cuda()
    caches = {}
    lg, caches["bf16"] = T.prefill(mc, packed, ptoks, 4080 + 33,
                                   cache_dtype=torch.bfloat16)
    _, caches["int8"] = T.prefill(mc, packed, ptoks, 4080 + 33,
                                  cache_dtype="int8")
    tok = torch.argmax(lg, -1)
    pos = torch.full((n_req,), 4080, dtype=torch.long, device="cuda")
    deltas, scale = [], 0.0
    for _ in range(32):
        out = {}
        for kind in ("bf16", "int8"):
            out[kind], caches[kind] = T.decode_step(mc, packed, tok, pos,
                                                    caches[kind])
        deltas.append(float((out["bf16"] - out["int8"]).abs().max()))
        scale = max(scale, float(out["bf16"].abs().max()))
        tok = torch.argmax(out["bf16"], -1)
        pos = pos + 1
    del caches
    early, late = max(deltas[:16]), max(deltas[16:])
    log(f"  drift int8 vs bf16 ring over 32 steps from position 4080 (the "
        f"wrap at step 16): max |dlogit| per step "
        f"{[round(d, 4) for d in deltas]}; max {max(deltas):.4f} = "
        f"{max(deltas) / scale:.3e} of max |logit| {scale:.3f}; late "
        f"{late:.4f} <= 3 x early {early:.4f} + 0.05: "
        f"{late <= 3 * early + 0.05}")
    check(late <= 3 * early + 0.05, "9a: int8 ring drift does not "
          "accumulate across the wrap")
    log(f"  decoded tokens (int8, prompt 4608, request 0): "
        f"{legs[0][2].tokens[0].tolist()}")
    del r, legs, packed
    return launches


# phase 9b's depth: 26 of pixtral's 40 layers fit quantization on the card;
# 13 kept the run inside its time limit once phases 13 and 14 came in, 4
# since phase 16 (training) did
VLM_LAYERS = 4


def phase_vlm_path(smi: str) -> dict:
    """9b: pixtral-12b at full width (d 5120, 32 heads over 8 KV heads,
    head_dim 128, d_ff 14336, vocab 131072), its depth cut to
    ``VLM_LAYERS`` of 40 layers: 26 is the most that quantization (the
    float layers before and after, ~2.3 GB a layer beside ~15 GB of
    embedding, head and work: ~75 GB at 26) fits on the card, and the
    whole run must stay inside its 1200 s; every calibration batch (4 x 2 x 128 tokens) and request (2 x 64
    tokens + 32 new) with the config's 1024 patch embeddings:
    quantize_model → pack_for_serving → generate, the replay bitwise the
    eager loop, decode starting at 64 + 1024, the packed int4 logits
    against the refined float logits in fp32 compute (1e-3; in bf16 the
    float model rounds its weights to bf16 before each product, which the
    packed one does not, so that reading is printed, not held); then
    ``launch.serve --arch pixtral-12b --pack-rtn`` at all 40 layers (49 GB
    of float weights, then int4) with its 8 patch embeddings a request,
    its tokens equal to pack_for_serving → generate called directly."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    from repro_torch.serving.engine import generate

    n_req, n_prompt, n_new, layers = 2, 64, 32, VLM_LAYERS
    r = drive_main_path("pixtral-12b", "fp16", n_req, n_prompt, n_new,
                        layers=layers, calib_shape=(4, 2, 128))
    cfg, launches = r["cfg"], r["launches"]
    mc = cfg.model
    check_path_launches(launches, "pixtral path",
                        ("selective_scan", "int8_kv_attention"))
    start = n_prompt + mc.frontend_tokens
    last = r["calib"][-1]
    rel = {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        lq = T.forward(mdt, r["packed"], last["tokens"].cuda(),
                       last["embeds"])
        lf = T.forward(mdt, r["params_q"], last["tokens"].cuda(),
                       last["embeds"])
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        finite = bool(torch.isfinite(lq).all())
        del lq, lf
    log(f"  decode started at positions {r['starts'][0]} (64 prompt tokens "
        f"after 1024 patch embeddings: {start})")
    log(f"  packed int4 vs refined-grid float logits on the last "
        f"calibration batch (1024 + 128 positions): fp32 compute rel err "
        f"{rel['float32']:.3e} (tol 1e-3); bf16 compute "
        f"{rel['bfloat16']:.5f} (not pinned: the float model's bf16 weight "
        f"rounding, as phase 6); finite {finite}")
    log(f"  decoded tokens (request 0): {r['res'].tokens[0].tolist()}")
    check(r["starts"] == [[start] * n_req] and rel["float32"] < 1e-3
          and finite
          and tuple(r["res"].tokens.shape) == (n_req, n_new),
          "9b: pixtral path output check")
    del r
    torch.cuda.empty_cache()

    log(f"  launch.serve --arch pixtral-12b --pack-rtn at all "
        f"{get_config('pixtral-12b').model.num_layers} layers ({n_req} "
        f"requests x {n_prompt} prompt + 8 patch embeddings + {n_new} new)")
    argv = ["--arch", "pixtral-12b", "--pack-rtn", "--batch", str(n_req),
            "--prompt-len", str(n_prompt), f"serve.max_new_tokens={n_new}"]
    torch.cuda.reset_peak_memory_stats()
    starts = []
    with patched(engine, "DecodeLoop", recording_starts(starts)):
        res, counts = serve_walls(LS, argv, launches, "pixtral-12b", smi)
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config("pixtral-12b")
    cfg.serve.max_new_tokens = n_new
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    packed = pack_for_serving(cfg, T.init_params(cfg.model, gen, "cuda"))
    batch = MarkovLM(cfg.model.vocab_size, seed=3).batch(n_req, n_prompt)
    gen = torch.Generator()
    gen.manual_seed(3)
    batch["embeds"] = torch.randn((n_req, 8, cfg.model.d_model),
                                  generator=gen)
    res_d = generate(cfg, packed, batch)
    del packed
    torch.cuda.empty_cache()
    same = bool(torch.equal(res.tokens, res_d.tokens))
    log(f"  tokens equal pack_for_serving -> generate called directly: "
        f"{same}; decode started at {starts} ({n_prompt} + 8); peak device "
        f"memory {peak} bytes [{smi}]; decoded tokens (request 0): "
        f"{res.tokens[0].tolist()}")
    check(same and starts == [[n_prompt + 8] * n_req]
          and counts["quant_pack"] > 0 and counts["w4a16_matmul"] > 0
          and tuple(res.tokens.shape) == (n_req, n_new),
          "9b: launch.serve --arch pixtral-12b --pack-rtn")
    return launches


def phase_encdec_path(smi: str) -> dict:
    """10: whisper-large-v3 at full width (d 1280, 20 heads of 64, d_ff
    5120, vocab 51866, 1500 frames), cut to ``ENCDEC_LAYERS`` encoder and
    as many decoder layers of its 32 + 32, seeded random weights, calibration 4 batches x 2 clips x
    (1500 seeded frames + 256 tokens): quantize_model → pack_for_serving →
    generate (4 requests x (1500 frames + 64 prompt tokens) + 32 new) with
    the bf16 and then the int8 self-cache, each replay bitwise its eager
    loop; the calibrated and RTN-packed linears (10 and 6 a layer: a decoder
    layer's self-attention and MLP sit under its ``layer`` key, which the
    calibration does not pick, as in the JAX package); the cache bytes;
    the int8-vs-bf16 drift rule of phase 6; the packed int4 logits
    against the refined float logits in fp32 compute (1e-3; the RTN-packed
    linears' float weights taken as their dequantized grid, the gap to the
    raw float weights printed; bf16 printed); ``encdec_prefill`` →
    ``encdec_decode_step`` against ``encdec_forward`` in fp32 compute on
    fp32 caches (1e-4, as phase 7's hand-off); then ``launch.serve --arch
    whisper-large-v3 --pack-rtn``, its tokens those of pack_for_serving →
    generate called directly."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.core.quant import dequantize_packed, quantized_leaves
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    from repro_torch.serving.engine import generate

    n_req, n_prompt, n_new = 4, 64, 32
    n_batches, clips, n_tok = 4, 2, 256
    cfg = get_config("whisper-large-v3")
    mc, qc = cfg.model, cfg.quant
    mc.num_layers = mc.encoder_layers = ENCDEC_LAYERS
    se = mc.encoder_seq_len
    log(f"  config: {mc.name} encoder layers={mc.encoder_layers} decoder "
        f"layers={mc.num_layers} d_model={mc.d_model} heads={mc.num_heads} "
        f"kv_heads={mc.num_kv_heads} head_dim={mc.head_dim} d_ff={mc.d_ff} "
        f"vocab={mc.vocab_size} norm={mc.norm} act={mc.act} use_rope="
        f"{mc.use_rope} dtype={mc.dtype}; quant group={qc.group_size} "
        f"blocksize={qc.blocksize} rpiq_iters={qc.rpiq_iters}; calibration "
        f"{n_batches} batches x {clips} clips x ({se} frames + {n_tok} "
        f"tokens); {n_req} requests x ({se} frames + {n_prompt} prompt "
        f"tokens) + {n_new} new (depth not cut)")

    def frames(b: int, seed: int):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return torch.randn((b, se, mc.d_model), generator=gen,
                           device="cuda")

    def tensors(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, list):
            for v in tree:
                yield from tensors(v)
        elif isinstance(tree, torch.Tensor):
            yield tree

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tensors(tree))

    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_encdec_params(mc, gen, "cuda")
    n_params = sum(t.numel() for t in tensors(params))
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), n_batches,
                                clips, n_tok)
    for i, b in enumerate(calib):
        b["frames"] = frames(clips, 20 + i)
    prompt = MarkovLM(mc.vocab_size, seed=3).batch(n_req, n_prompt)
    prompt["frames"] = frames(n_req, 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    params_q, report = quantize_model(cfg, params, calib)
    t1 = time.perf_counter()
    del params
    packed = pack_for_serving(cfg, params_q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before = ops.kernel_launches()
    starts, pre = [], []
    with patched(engine, "DecodeLoop", recording_starts(starts)), \
            patched(engine, "prefill", timed(pre)):
        res = generate(cfg, packed, prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    gen_launches = {k: launches[k] - before[k] for k in launches}

    n_cal = sum(1 for r in report.linears if r.mode != "skipped")
    names = [k for k, _ in quantized_leaves(packed)]
    n_rtn = len(names) - n_cal
    rtn_under_layer = sum(1 for k in names if ".layer." in k)
    xattn = sum(1 for r in report.linears if r.name.startswith("xattn."))
    rest = report.seconds_total - report.seconds_stage1 \
        - report.seconds_stage2
    steps = report.layer_step_seconds
    n_enc = mc.encoder_layers
    log(f"  parameters: {n_params} ({2 * n_params} bytes in bf16)")
    log(f"  kernels: {json.dumps(launches)}")
    log(f"  report: {report.summary()}")
    log(f"  linears: {n_cal} calibrated ({xattn} of them the decoder's "
        f"xattn.*), {len(names)} packed: {n_rtn} on a fresh (RTN) grid, "
        f"{rtn_under_layer} of them under a decoder layer's 'layer' key "
        f"(its self-attention and MLP)")
    log(f"  walls (s) [{smi}]: quantize_model={t1 - t0:.3f} (stage1="
        f"{report.seconds_stage1:.3f} stage2={report.seconds_stage2:.3f} "
        f"capture+propagate+rest={rest:.3f}) pack_for_serving="
        f"{t2 - t1:.3f} generate={t3 - t2:.3f} (its prefill, encoder "
        f"included, {pre[0]:.4f}; its decode step's graph capture "
        f"{res.capture_s:.4f}); decode started at positions {starts[0]}")
    enc_mean = sum(steps[:n_enc]) / n_enc
    dec_mean = sum(steps[n_enc:]) / max(1, len(steps) - n_enc)
    log(f"  layer step walls (s): encoder mean {enc_mean:.3f} max "
        f"{max(steps[:n_enc]):.3f}; decoder mean {dec_mean:.3f} max "
        f"{max(steps[n_enc:]):.3f}")
    log(f"  peak device memory (the decode graph's pool in it): {peak} "
        f"bytes, of which {held_before} were held by earlier phases: this "
        f"path {peak - held_before} bytes")
    n_l = mc.num_layers
    check(n_cal == 10 * n_l and xattn == 4 * n_l and n_rtn == 6 * n_l
          and rtn_under_layer == 6 * n_l and len(steps) == 2 * n_l,
          "10: 10 calibrated and 6 RTN-packed linears a layer")
    check(starts == [[n_prompt] * n_req], "10: decode starts at the prompt")
    decode_graph_checks(cfg, packed, prompt, res, gen_launches, n_new)
    check_path_launches(launches, "bf16-cache whisper leg",
                        ("selective_scan", "int8_kv_attention"))

    log("  the int8 self-cache leg")
    cfg8 = get_config("whisper-large-v3")
    cfg8.model = mc
    cfg8.serve.kv_cache = "int8"
    before = ops.kernel_launches()
    pre8 = []
    with patched(engine, "prefill", timed(pre8)):
        res8 = generate(cfg8, packed, prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    gen8 = {k: after[k] - before[k] for k in after}
    for k, n in gen8.items():
        launches[k] += n
    log(f"  int8 leg: prefill {pre8[0]:.4f} s, capture {res8.capture_s:.4f}"
        f" s; launches {json.dumps(gen8)}")
    check(gen8["int8_kv_attention"] == mc.num_layers * (n_new - 1),
          f"10: int8_kv_attention launched {gen8['int8_kv_attention']} "
          f"times, expected {mc.num_layers * (n_new - 1)}")
    decode_graph_checks(cfg8, packed, prompt, res8, gen8, n_new)

    inputs = {k: v.cuda() for k, v in prompt.items()}
    max_len = n_prompt + n_new + 1
    cache_b = {}
    for kind, c in (("bf16", cfg), ("int8", cfg8)):
        _, caches = engine.prefill(c, packed, inputs, max_len)
        cache_b[kind] = (nbytes([x["self"] for x in caches]),
                         nbytes([x["cross"] for x in caches]))
        del caches
    log(f"  caches at {n_req} x {max_len} self slots, {n_req} x {se} cross "
        f"slots: cross {cache_b['bf16'][1]} bytes (bf16, also beside the "
        f"int8 self-cache: {cache_b['int8'][1]}); self bf16 "
        f"{cache_b['bf16'][0]} vs int8 {cache_b['int8'][0]} "
        f"({cache_b['bf16'][0] / cache_b['int8'][0]:.2f}x)")
    check(cache_b["int8"][1] == cache_b["bf16"][1]
          == 2 * mc.num_layers * n_req * se * mc.d_model * 2,
          "10: the cross-cache stays bf16 beside the int8 self-cache")

    # drift: the int8 and the bf16 self-cache fed the same (bf16-chosen)
    # stream, 16 steps
    fr, ptoks = inputs["frames"], inputs["tokens"]
    lg, c16 = T.encdec_prefill(mc, packed, fr, ptoks, n_prompt + 17)
    _, c8 = T.encdec_prefill(mc, packed, fr, ptoks, n_prompt + 17, "int8")
    tok = torch.argmax(lg, -1)
    pos = torch.full((n_req,), n_prompt, dtype=torch.long, device="cuda")
    deltas, scale = [], 0.0
    for _ in range(16):
        out16, c16 = T.encdec_decode_step(mc, packed, tok, pos, c16)
        out8, c8 = T.encdec_decode_step(mc, packed, tok, pos, c8)
        deltas.append(float((out16 - out8).abs().max()))
        scale = max(scale, float(out16.abs().max()))
        tok = torch.argmax(out16, -1)
        pos = pos + 1
    del c16, c8
    early, late = max(deltas[:8]), max(deltas[8:])
    log(f"  drift int8 vs bf16 self-cache over 16 steps: max |dlogit| per "
        f"step {[round(d, 4) for d in deltas]}; max {max(deltas):.4f} = "
        f"{max(deltas) / scale:.3e} of max |logit| {scale:.3f}; late "
        f"{late:.4f} <= 3 x early {early:.4f} + 0.05: "
        f"{late <= 3 * early + 0.05}")
    check(late <= 3 * early + 0.05, "10: int8 self-cache drift does not "
          "accumulate")

    # packed int4 against the refined grid: the RTN-packed linears' float
    # weights become their dequantized grid, so in fp32 compute the two
    # models differ in summation order only
    def restructured(tree):
        if isinstance(tree, dict):
            return {k: restructured(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [restructured(v) for v in tree]
        return tree

    refined = restructured(params_q)
    for name, qt in quantized_leaves(packed):
        node = resolve(refined, name.rsplit(".", 1)[0])
        if "qscales" not in node:           # packed on a fresh grid
            node["w"] = dequantize_packed(qt).T.contiguous()
    last = calib[-1]
    rel = {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        lq, _ = T.encdec_forward(mdt, packed, last["frames"],
                                 last["tokens"].cuda())
        lf, _ = T.encdec_forward(mdt, refined, last["frames"],
                                 last["tokens"].cuda())
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        if dt == "float32":
            lraw, _ = T.encdec_forward(mdt, params_q, last["frames"],
                                       last["tokens"].cuda())
            rel["raw"] = float((lq - lraw).norm() / (lraw.norm() + 1e-9))
            del lraw
        finite = bool(torch.isfinite(lq).all())
        del lq, lf
    log(f"  packed int4 vs refined-grid float logits on the last "
        f"calibration batch: fp32 compute rel err {rel['float32']:.3e} "
        f"(tol 1e-3); bf16 compute {rel['bfloat16']:.5f} (not pinned: the "
        f"float model's bf16 weight rounding, as phase 6); against the raw "
        f"float decoder self-attention and MLP weights (their RTN error) "
        f"fp32 {rel['raw']:.5f}; finite {finite}")
    check(rel["float32"] < 1e-3 and finite, "10: packed vs refined logits")
    del refined

    # the prefill -> decode hand-off against the full-sequence forward, in
    # fp32 compute on fp32 caches
    m32 = dataclasses.replace(mc, dtype="float32")
    toks = torch.cat([ptoks, res.tokens[:, :8].to(ptoks.dtype)], dim=1)
    full, _ = T.encdec_forward(m32, packed, fr, toks)
    lg, caches = T.encdec_prefill(m32, packed, fr, ptoks, n_prompt + 9,
                                  cache_dtype=torch.float32)

    def rel_to(a, b):
        return float((a - b).norm() / b.norm())

    errs = [rel_to(lg, full[:, n_prompt - 1])]
    pos = torch.full((n_req,), n_prompt, dtype=torch.long, device="cuda")
    for i in range(8):
        lg, caches = T.encdec_decode_step(m32, packed, toks[:, n_prompt + i],
                                          pos, caches)
        errs.append(rel_to(lg, full[:, n_prompt + i]))
        pos = pos + 1
    del full, caches
    log(f"  encdec_prefill + 8 encdec_decode_steps against encdec_forward "
        f"(fp32 compute, fp32 caches): rel err per position "
        f"{[f'{e:.2e}' for e in errs]} (tol 1e-4)")
    check(max(errs) < 1e-4, "10: prefill -> decode hand-off")
    log(f"  decoded tokens (request 0, bf16 / int8 self-cache): "
        f"{res.tokens[0].tolist()} / {res8.tokens[0].tolist()}")
    check(tuple(res.tokens.shape) == tuple(res8.tokens.shape)
          == (n_req, n_new), "10: whisper path output shapes")
    del packed, params_q, res, res8
    torch.cuda.empty_cache()

    log(f"  launch.serve --arch whisper-large-v3 --pack-rtn ({n_req} "
        f"requests x ({se} frames + {n_prompt} prompt tokens) + {n_new} "
        f"new)")
    argv = ["--arch", "whisper-large-v3", "--pack-rtn", "--batch",
            str(n_req), "--prompt-len", str(n_prompt),
            f"serve.max_new_tokens={n_new}",
            f"model.num_layers={n_l}", f"model.encoder_layers={n_l}"]
    starts = []
    with patched(engine, "DecodeLoop", recording_starts(starts)):
        res_l, counts = serve_walls(LS, argv, launches, "whisper-large-v3",
                                    smi)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    packed = pack_for_serving(cfg, T.init_encdec_params(mc, gen, "cuda"))
    batch = MarkovLM(mc.vocab_size, seed=3).batch(n_req, n_prompt)
    gen = torch.Generator()
    gen.manual_seed(3)
    batch["frames"] = torch.randn((n_req, se, mc.d_model), generator=gen)
    res_d = generate(cfg, packed, batch, max_new_tokens=n_new)
    del packed
    torch.cuda.empty_cache()
    same = bool(torch.equal(res_l.tokens, res_d.tokens))
    log(f"  tokens equal pack_for_serving -> generate called directly: "
        f"{same}; decode started at {starts}; decoded tokens (request 0): "
        f"{res_l.tokens[0].tolist()}")
    check(same and starts == [[n_prompt] * n_req]
          and counts["quant_pack"] > 0 and counts["w4a16_matmul"] > 0,
          "10: launch.serve --arch whisper-large-v3 --pack-rtn")
    return launches


def serve_leg(cfg, packed, prompt, n_new: int, label: str, smi: str
              ) -> tuple:
    """One more ``generate`` on the packed model (its walls and launches
    printed), then ``decode_graph_checks``; returns its launch counts and
    its result."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import engine
    from repro_torch.serving.engine import generate

    torch.cuda.synchronize()
    t = time.perf_counter()
    before = ops.kernel_launches()
    pre = []
    with patched(engine, "prefill", timed(pre)):
        res = generate(cfg, packed, prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    after = ops.kernel_launches()
    counts = {k: after[k] - before[k] for k in after}
    log(f"  leg {label}: generate {wall:.3f} s, prefill {pre[0]:.4f}, "
        f"capture {res.capture_s:.4f} [{smi}]; launches "
        f"{json.dumps(counts)}")
    decode_graph_checks(cfg, packed, prompt, res, counts, n_new)
    return counts, res


def chunked_against_single(cfg, packed, toks, chunk: int) -> float:
    """The relative error of the chunked prefill's logits (chunks of
    ``chunk``) against the single-shot prefill's, in fp32 compute on fp32
    caches."""
    import torch
    from repro_torch.models import transformer as T
    m32 = dataclasses.replace(cfg.model, dtype="float32")
    max_len = toks.shape[1] + 2
    one, _ = T.prefill(m32, packed, toks, max_len, cache_dtype=torch.float32)
    chunked, _ = T.prefill_chunked(m32, packed, toks, max_len, chunk,
                                   cache_dtype=torch.float32)
    return float((chunked - one).norm() / one.norm())


def packed_against_refined(mc, packed, params_q, toks) -> dict:
    """Packed int4 against refined float logits on ``toks``, fp32 and bf16
    compute (the relative errors), and the MTP head's where the model has
    one. A linear packed on a fresh grid (the MTP layer's, RTN) enters the
    refined model dequantized, so the two differ by the packing alone."""
    import torch
    from repro_torch.core.quant import dequantize_packed, quantized_leaves
    from repro_torch.models import transformer as T

    def restructured(tree):
        if isinstance(tree, dict):
            return {k: restructured(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [restructured(v) for v in tree]
        return tree

    refined = restructured(params_q)
    for name, qt in quantized_leaves(packed):
        node = resolve(refined, name.rsplit(".", 1)[0])
        if "qscales" not in node:           # packed on a fresh grid
            node["w"] = dequantize_packed(qt).T.contiguous()
    rel = {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        lq, hq = T.forward_hidden(mdt, packed, toks)
        lf, hf = T.forward_hidden(mdt, refined, toks)
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        rel["finite"] = bool(torch.isfinite(lq).all())
        del lq, lf
        if mc.mtp_depth:
            mq = T.mtp_logits(mdt, packed, hq, toks)
            mf = T.mtp_logits(mdt, refined, hf, toks)
            rel[f"mtp {dt}"] = float((mq - mf).norm() / (mf.norm() + 1e-9))
            rel["mtp shape"] = tuple(mq.shape)
            del mq, mf
        del hq, hf
    return rel


def phase_hybrid_path(smi: str) -> dict:
    """13: recurrentgemma-9b at full width (d 4096, 16 heads over one
    kv-head of 256, lru_width 4096, d_ff 12288, vocab 256000 tied, window
    2048, logits soft-capped at 30), its depth cut to ``HYBRID_LAYERS``
    of 38 layers (whole (rglru, rglru, local) periods: quantization holds
    the float layers before and after, ~2.2x the parameter bytes, 77.8 GB
    at 38 layers, which fit; the cut keeps the whole run inside its
    1200 s), calibration 4 x 4 x 512 → quantize_model →
    pack_for_serving → generate on the bf16 ring (4 x 512 + 32), then on
    the int8 ring (the R-16 ``int8_kv_attention``) and 1 x 2040 + 32 on
    the int8 ring, whose decode crosses the 2048-slot window inside the
    replay; each replay bitwise its eager loop. Held: the packed int4
    against the refined float logits in fp32 compute (1e-3), the chunked
    (128) against the single-shot prefill in fp32 (1e-4, the RG-LRU state
    carried across chunks); then ``launch.serve --arch recurrentgemma-9b
    --pack-rtn`` at all 38 layers, its tokens those of pack_for_serving →
    generate called directly."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    n_req, n_prompt, n_new, layers = 4, 512, 32, HYBRID_LAYERS
    r = drive_main_path("recurrentgemma-9b", "fp16", n_req, n_prompt, n_new,
                        layers=layers, calib_shape=(4, 4, 512))
    cfg, packed, launches = r["cfg"], r["packed"], r["launches"]
    mc = cfg.model
    check(r["starts"] == [[n_prompt] * n_req], "13: decode starts after the "
          "prompt")
    rel = packed_against_refined(mc, packed, r["params_q"],
                                 r["calib"][-1]["tokens"].cuda())
    log(f"  packed int4 vs refined-grid float logits on the last "
        f"calibration batch: fp32 compute rel err {rel['float32']:.3e} "
        f"(tol 1e-3); bf16 compute {rel['bfloat16']:.5f} (not pinned: the "
        f"float model's bf16 weight rounding, as phase 6); finite "
        f"{rel['finite']}")
    check(rel["float32"] < 1e-3 and rel["finite"], "13: packed vs refined "
          "logits")
    del r["params_q"]
    torch.cuda.empty_cache()
    crel = chunked_against_single(cfg, packed, r["prompt"]["tokens"].cuda(),
                                  128)
    log(f"  chunked (128) against single-shot prefill, {n_req} x {n_prompt}"
        f", fp32 compute and caches: logits rel err {crel:.3e} (tol 1e-4)")
    check(crel <= 1e-4, "13: chunked against single-shot prefill")

    cfg.serve.kv_cache = "int8"
    legs = [("int8 ring", r["prompt"]),
            ("int8 ring across the wrap", MarkovLM(mc.vocab_size, seed=3)
             .batch(1, 2040))]
    for label, prompt in legs:
        n = prompt["tokens"].shape[1]
        counts, _ = serve_leg(cfg, packed, prompt, n_new,
                              f"{label}, {prompt['tokens'].shape[0]} x {n} "
                              f"prompt + {n_new} new", smi)
        for k, v in counts.items():
            launches[k] += v
    caches = T.init_caches(mc, 1, 2040 + n_new + 1, "cuda", "int8")
    state = sum(t.numel() * t.element_size()
                for spec, c in zip(T.layer_specs(mc), caches)
                if spec[0] == "rglru" for t in c.values())
    ring = sum(t.numel() * t.element_size()
               for spec, c in zip(T.layer_specs(mc), caches)
               if spec[0] != "rglru" for t in c.values())
    del caches
    log(f"  decode state of one request at 2040 + {n_new} positions "
        f"({layers} layers): RG-LRU states {state} bytes, int8 rings of "
        f"{min(mc.window_size, 2040 + n_new + 1)} slots {ring} bytes; "
        f"bounded whatever the session's length")
    check_path_launches(launches, "hybrid path", ("selective_scan",))
    del r, packed
    torch.cuda.empty_cache()

    full = get_config("recurrentgemma-9b").model.num_layers
    n_req, n_prompt = 2, 64
    log(f"  launch.serve --arch recurrentgemma-9b --pack-rtn at all {full} "
        f"layers ({n_req} requests x {n_prompt} prompt + {n_new} new)")
    argv = ["--arch", "recurrentgemma-9b", "--pack-rtn", "--batch",
            str(n_req), "--prompt-len", str(n_prompt),
            f"serve.max_new_tokens={n_new}"]
    torch.cuda.reset_peak_memory_stats()
    res, counts = serve_walls(LS, argv, launches, "recurrentgemma-9b", smi)
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config("recurrentgemma-9b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    packed = pack_for_serving(cfg, T.init_params(cfg.model, gen, "cuda"))
    batch = MarkovLM(cfg.model.vocab_size, seed=3).batch(n_req, n_prompt)
    res_d = generate(cfg, packed, batch, max_new_tokens=n_new)
    del packed
    torch.cuda.empty_cache()
    same = bool(torch.equal(res.tokens, res_d.tokens))
    log(f"  tokens equal pack_for_serving -> generate called directly: "
        f"{same}; peak device memory {peak} bytes [{smi}]; decoded tokens "
        f"(request 0): {res.tokens[0].tolist()}")
    check(same and counts["quant_pack"] > 0 and counts["w4a16_matmul"] > 0
          and tuple(res.tokens.shape) == (n_req, n_new),
          "13: launch.serve --arch recurrentgemma-9b --pack-rtn")
    return launches


def phase_mla_path(smi: str) -> dict:
    """14: deepseek-v3-671b at full width (d 7168, 128 heads, q / kv ranks
    1536 / 512, nope / rope / v 128 / 64 / 128, d_ff 18432, vocab 129280)
    cut to its 3 dense layers (``first_dense_layers``) with the MTP head
    (whose layer, of the last layer's spec, is then dense too): a routed
    layer's 256 experts alone hold ~11.3 B parameters, and their stacked
    Hessians ~52.6 GB. Calibration 4 x 4 x 512 → quantize_model →
    pack_for_serving (the MTP layer RTN-packed, its projection float) →
    generate on the bf16 latent cache (4 x 512 + 32; every decode step
    expands the whole latent cache through k_up / v_up), the replay bitwise
    its eager loop. Held: the packed int4 against the refined float logits
    and MTP logits in fp32 compute (1e-3), the chunked (128) against the
    single-shot prefill in fp32 (1e-4); printed: the latent cache's bytes
    against a full K/V cache of the same shape."""
    import torch
    from repro_torch.core.quant import quantized_leaves
    from repro_torch.models import transformer as T

    n_req, n_prompt, n_new, layers = 4, 512, 32, 3
    r = drive_main_path("deepseek-v3-671b", "fp16", n_req, n_prompt, n_new,
                        layers=layers, calib_shape=(4, 4, 512))
    cfg, packed, launches = r["cfg"], r["packed"], r["launches"]
    mc, m = cfg.model, cfg.model.mla
    check(r["starts"] == [[n_prompt] * n_req] and all(
        s == ("mla", "dense") for s in T.layer_specs(mc)),
        "14: three dense MLA layers, decode after the prompt")
    mtp_packed = [n for n, _ in quantized_leaves(packed["mtp"])]
    log(f"  MTP head: {len(mtp_packed)} RTN-packed linears "
        f"({', '.join(mtp_packed)}); proj float "
        f"{tuple(packed['mtp']['proj']['w'].shape)}")
    check(len(mtp_packed) == 10
          and isinstance(packed["mtp"]["proj"]["w"], torch.Tensor),
          "14: the MTP layer packed, its projection float")
    rel = packed_against_refined(mc, packed, r["params_q"],
                                 r["calib"][-1]["tokens"].cuda())
    log(f"  packed int4 vs refined-grid float logits on the last "
        f"calibration batch: fp32 compute rel err {rel['float32']:.3e} "
        f"(tol 1e-3), bf16 {rel['bfloat16']:.5f} (not pinned); mtp_logits "
        f"{rel['mtp shape']} fp32 {rel['mtp float32']:.3e} (tol 1e-3), bf16 "
        f"{rel['mtp bfloat16']:.5f}; finite {rel['finite']}")
    check(rel["float32"] < 1e-3 and rel["mtp float32"] < 1e-3
          and rel["finite"], "14: packed vs refined logits")
    del r["params_q"]
    torch.cuda.empty_cache()
    crel = chunked_against_single(cfg, packed, r["prompt"]["tokens"].cuda(),
                                  128)
    log(f"  chunked (128) against single-shot prefill, {n_req} x {n_prompt}"
        f", fp32 compute and caches (continuations over the cached "
        f"latents): logits rel err {crel:.3e} (tol 1e-4)")
    check(crel <= 1e-4, "14: chunked against single-shot prefill")
    max_len = n_prompt + n_new + 1
    caches = T.init_caches(mc, n_req, max_len, "cuda")
    latent = sum(t.numel() * t.element_size() for c in caches
                 for t in c.values())
    del caches
    expanded = (layers * n_req * max_len * mc.num_heads * 2
                * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim))
    log(f"  bf16 latent cache ({layers} layers, {n_req} lanes x {max_len} "
        f"slots, {m.kv_lora_rank} + {m.qk_rope_head_dim} a token): "
        f"{latent} bytes against {expanded} for the expanded K/V "
        f"({mc.num_heads} heads x ({m.qk_nope_head_dim + m.qk_rope_head_dim}"
        f" + {m.v_head_dim})): {expanded / latent:.1f}x smaller")
    check_path_launches(launches, "MLA path",
                        ("selective_scan", "int8_kv_attention"))
    log(f"  decoded tokens (request 0): {r['res'].tokens[0].tolist()}")
    check(tuple(r["res"].tokens.shape) == (n_req, n_new) and latent
          < expanded, "14: MLA path output check")
    del r, packed
    torch.cuda.empty_cache()
    return launches


def event_timed(walls: dict, label: str):
    """A wrapper maker for ``patched`` on a kernel wrapper taking a stacked
    (B, out, in) first argument: each call's device time (CUDA events,
    synchronised) is appended to ``walls[(label, (B, out, in, n))]``, n
    the token count of its third argument where it has one (rpiq_block's
    x), else 0."""
    import torch

    def make(fn):
        def wrapper(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            n = args[2].shape[1] if len(args) > 2 else 0
            walls.setdefault((label, (*args[0].shape, n)), []).append(
                start.elapsed_time(end))
            return out
        return wrapper
    return make


def phase_moe_path(smi: str) -> dict:
    """11: olmoe-1b-7b at full width and depth (16 layers, d 2048, 16 heads
    of 128, 64 experts, top 8, d_ff_expert 1024, vocab 50304) from seeded
    random weights, calibration 4 batches x 4 x 512 tokens (T 2048 a
    batch: capacity C 320 rows an expert) → quantize_model (per layer one
    attention group (4, 2048, 2048) at n 2048 and the stacked expert groups
    (128, 1024, 2048) and (64, 2048, 1024) at n 320) → pack_for_serving →
    generate on the int8 KV cache (4 requests x 512 prompt + 32 new), the
    replay bitwise the eager loop; each ``gptq_block`` / ``rpiq_block``
    call's device time by group, the capacity drops and starved lanes;
    the packed experts' bf16 weights bitwise the refined float experts';
    the packed int4 logits against the refined float logits in fp32
    compute on the same routing plans (1e-2, phase 4's MoE pin: the experts
    compute in bf16; bf16, and each model on its own routing, printed with
    the count of top-k sets and capacity keeps that differ), the int8 drift
    rule of phase 6, the artifact bytes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    n_req, n_prompt, n_new = 4, 512, 32
    walls: dict = {}
    with patched(ops, "gptq_block_cuda", event_timed(walls, "gptq_block")), \
            patched(ops, "rpiq_block_cuda", event_timed(walls,
                                                        "rpiq_block")):
        r = drive_main_path("olmoe-1b-7b", "int8", n_req, n_prompt, n_new,
                            calib_shape=(4, 4, 512))
    keep_serial("olmoe-1b-7b", r)
    cfg, params_q, packed = r["cfg"], r["params_q"], r["packed"]
    launches, res, report = r["launches"], r["res"], r["report"]
    mc = cfg.model
    for (label, shape), ms in sorted(walls.items()):
        log(f"  {label} (B, out, in, n)={shape}: {len(ms)} calls, mean "
            f"{sum(ms) / len(ms):.3f} ms, total {sum(ms):.1f} ms")
    check_path_launches(launches, "MoE path", ("selective_scan",))
    decode_calls = mc.num_layers * (n_new - 1)
    check(launches["int8_kv_attention"] == decode_calls,
          f"int8_kv_attention launched {launches['int8_kv_attention']} "
          f"times, expected {decode_calls} (layers x decode steps)")
    modes = {}
    for rec in report.linears:
        modes[rec.mode] = modes.get(rec.mode, 0) + 1
    assignments = mc.num_layers * 4 * (4 * 512) * mc.moe.top_k
    dropped = sum(report.moe_capacity_dropped.values())
    log(f"  records by mode {modes}; capacity-dropped (token, k) "
        f"assignments {dropped} of {assignments} "
        f"({dropped / assignments:.3%}), per layer "
        f"{list(report.moe_capacity_dropped.values())}")
    check(modes.get("rpiq", 0) > 0
          and sum(modes.values()) == mc.num_layers * (4 + 3 * 64)
          and set(modes) <= {"rpiq", "rtn-fallback"},
          "the MoE path's records")

    # the packed experts dequantize to the refined experts' bf16 values
    n_same = sum(int(torch.equal(moe_mod._expert_weights(lq["mlp"][w]),
                                 moe_mod._expert_weights(lf["mlp"][w])))
                 for lq, lf in zip(packed["layers"], params_q["layers"])
                 for w in ("w_gate", "w_up", "w_down"))
    log(f"  packed experts' bf16 weights bitwise the refined float "
        f"experts': {n_same} of {3 * mc.num_layers}")
    # packed against refined logits in fp32 compute: the float forward
    # replays the packed forward's routing plans (top-k ids, sort, capacity
    # keeps), so the numbers compare on the same dispatch. The experts run
    # in bf16 at any model dtype (as in the reference), so an expert input
    # one fp32 rounding apart may round to the neighbouring bf16 value
    # (2^-8 of it): phase 4's MoE pin, 1e-2. On each model's own routing a
    # top-k set that flips moves its experts' capacity cut for every later
    # token, and the flips cascade through the layers: printed
    toks = r["calib"][-1]["tokens"].cuda()
    rel, free, moved = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        mdt = dataclasses.replace(mc, dtype=dt)
        plans_q, plans_f = [], []
        with patched(moe_mod, "route", recording_plans(plans_q)):
            lq = T.forward(mdt, packed, toks)
        with patched(moe_mod, "route", replaying_plans(list(plans_q))):
            lf = T.forward(mdt, params_q, toks)
        rel[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        with patched(moe_mod, "route", recording_plans(plans_f)):
            lf = T.forward(mdt, params_q, toks)
        free[dt] = float((lq - lf).norm() / (lf.norm() + 1e-9))
        moved[dt] = [sum(int((a.experts != b.experts).any(-1).sum())
                         for a, b in zip(plans_q, plans_f)),
                     sum(int((a.keep != b.keep).sum())
                         for a, b in zip(plans_q, plans_f))]
        if dt == "bfloat16":
            finite = bool(torch.isfinite(lq).all())
        del lq, lf, plans_q, plans_f
    log(f"  packed int4 vs refined-grid float logits on the same routing: "
        f"fp32 compute rel err {rel['float32']:.3e} (tol 1e-2); bf16 "
        f"compute {rel['bfloat16']:.5f} (not pinned); finite {finite}")
    log(f"  the same on each model's own routing (not pinned): fp32 "
        f"{free['float32']:.3e}, bf16 {free['bfloat16']:.5f}; (token, "
        f"layer) top-k sets that differ / capacity keeps that differ: fp32 "
        f"{moved['float32']}, bf16 {moved['bfloat16']} of "
        f"{mc.num_layers * toks.numel()} / "
        f"{mc.num_layers * toks.numel() * mc.moe.top_k}")
    log(f"  decoded tokens (request 0): {res.tokens[0].tolist()} steps "
        f"{res.steps.tolist()}")
    check(rel["float32"] < 1e-2 and finite and n_same == 3 * mc.num_layers
          and tuple(res.tokens.shape) == (n_req, n_new),
          "MoE path output check")
    int8_drift(mc, packed, r["prompt"]["tokens"].cuda())
    art = sum(t.numel() * t.element_size() for t in tensors_of(packed))
    log(f"  packed artifact tensors: {art} bytes ({smi})")
    return launches


def drive_continuous(eng, requests, spec=None) -> dict:
    """Submit every (batch, budget) request at once to ``eng`` (a
    ContinuousEngine or SupervisedEngine), with ``spec`` armed, and tick
    until it drains; per request the host-clock time to the first token
    and to the finish (each tick ends in the host's read of its tokens,
    so the clock sees the device's work), and the tick count."""
    import torch
    from repro_torch.core import faults
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(b, max_new_tokens=m) for b, m in requests]
    first, end, done, ticks = {}, {}, {}, 0
    with faults.inject(*([spec] if spec else [])):
        while not eng.idle:
            rep = eng.step()
            ticks += 1
            now = time.perf_counter() - t0
            for rid, _ in rep.first_tokens:
                first.setdefault(rid, now)
            for f in rep.finished:
                done[f.rid] = f
                end[f.rid] = now
    torch.cuda.synchronize()
    return dict(rids=rids, done=done, first=first, end=end, ticks=ticks,
                wall=time.perf_counter() - t0)


def phase_continuous_path(smi: str) -> dict:
    """internlm2-1.8b at full width and depth (24 layers, d 2048, GQA
    16 / 8) behind the continuous engine: RTN-packed seeded weights, the
    int8 cache, ``serve.max_batch`` 8, ``prefill_chunk`` 128, ``max_len``
    1024; 24 seeded requests (prompts 32-512 tokens, budgets 16-64)
    submitted at once and drained with the launch counters reset just
    before and read just after. Prints the ticks, the eager and the
    replayed tick walls, the prefill-chunk walls, each request's time to
    first token and total, generated tokens per second, the capture wall,
    a replayed tick's idle share, peak memory and the launches. Holds: the
    chunked prefill against the single-shot one (fp32 compute on a fp32
    cache, 1e-4); the replayed tick bitwise the eager tick; row
    independence (lane 0's cache and token changed, every other lane's
    tick output bitwise the same); a ``serve.decode_step`` quarantine
    leaving every other request's tokens bitwise the fault-free run's; a
    ``serve.engine_step`` kill under ``SupervisedEngine`` completing every
    request within its budget (how many come out token-identical is
    reported: the replay prefills what the dead engine decoded). Reports,
    for two requests, their tokens against the static engine at batch 1
    (another m than the tick's): the first divergent token and the top-2
    logit gap there."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import ContinuousEngine
    from repro_torch.serving.supervisor import SupervisedEngine

    cfg = get_config("internlm2-1.8b")
    cfg.serve.kv_cache = "int8"
    cfg.serve.max_batch, cfg.serve.prefill_chunk = 8, 128
    mc, cap, n_req = cfg.model, 1024, 24
    rs = np.random.RandomState(12)
    lens = rs.randint(32, 513, n_req).tolist()
    budgets = rs.randint(16, 65, n_req).tolist()
    data = MarkovLM(mc.vocab_size, seed=3)
    requests = [(data.batch(1, n), m) for n, m in zip(lens, budgets)]
    log(f"  config: {mc.name} layers={mc.num_layers} d_model={mc.d_model} "
        f"heads={mc.num_heads} kv_heads={mc.num_kv_heads} head_dim="
        f"{mc.head_dim} d_ff={mc.d_ff} vocab={mc.vocab_size} dtype="
        f"{mc.dtype} (depth not cut); RTN-packed seeded weights, group "
        f"{cfg.quant.group_size}; serve kv_cache=int8 max_batch="
        f"{cfg.serve.max_batch} prefill_chunk={cfg.serve.prefill_chunk} "
        f"max_len={cap}; {n_req} requests, prompts {lens}, budgets "
        f"{budgets}")
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cuda")
    t = time.perf_counter()
    packed = pack_for_serving(cfg, params)
    torch.cuda.synchronize()
    log(f"  pack_for_serving (RTN) {time.perf_counter() - t:.3f}s")
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the fault-free run, instrumented: each prefill chunk and each tick
    # timed with the device synchronised after it
    eng = ContinuousEngine(cfg, packed, max_len=cap)
    chunk_w, tick_w = [], []
    real_tick = eng._greedy_tick

    def timed_tick():
        kind = "replay" if eng._graph is not None else (
            "eager" if not eng._warm else "capture+replay")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_tick()
        torch.cuda.synchronize()
        tick_w.append((kind, time.perf_counter() - t))
        return out

    eng._greedy_tick = timed_tick
    ops.reset_kernel_launches()
    with patched(engine, "prefill_step", timed(chunk_w)):
        run = drive_continuous(eng, requests)
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    done, rids = run["done"], run["rids"]
    ok = all(done[r].status == "ok" and done[r].steps == m
             for r, (_, m) in zip(rids, requests))
    n_tok = sum(done[r].steps for r in rids)
    replays = [w for k, w in tick_w if k == "replay"]
    eager = [w for k, w in tick_w if k == "eager"]
    ttft = [round(run["first"][r], 4) for r in rids]
    total = [round(run["end"][r], 4) for r in rids]
    log(f"  kernels: {json.dumps(launches)}")
    log(f"  ({smi}) {run['ticks']} ticks in {run['wall']:.3f}s: "
        f"{n_tok} generated tokens, {n_tok / run['wall']:.1f} tokens/s; "
        f"all {n_req} requests ok at their budgets {ok}")
    log(f"  tick walls (s, device synchronised): eager {eager[0]:.5f}; "
        f"replayed mean {sum(replays) / len(replays):.5f} min "
        f"{min(replays):.5f} max {max(replays):.5f} (of {len(replays)}); "
        f"capture {eng.capture_s:.4f}")
    log(f"  prefill chunk walls (s): {len(chunk_w)} chunks, mean "
        f"{sum(chunk_w) / len(chunk_w):.5f} min {min(chunk_w):.5f} max "
        f"{max(chunk_w):.5f}; sum {sum(chunk_w):.3f}")
    log(f"  time to first token (s) per request: {ttft}")
    log(f"  time to finish (s) per request: {total}")
    log(f"  peak device memory of the run: {peak} bytes, of which "
        f"{held_before} were held by earlier phases")
    busy = device_breakdown(eng._graph.replay, "replayed tick")
    if busy is not None:
        r_ms = sum(replays) / len(replays) * 1e3
        log(f"  replayed tick: device busy {busy:.2f} ms of the "
            f"unprofiled {r_ms:.2f} ms, idle share {1 - busy / r_ms:.3f}")
    check(ok and launches["w4a16_matmul"] > 0
          and launches["int8_kv_attention"] > 0 and replays,
          "the continuous path at full width")
    # where a prefill chunk's time goes: the last chunk of the longest
    # prompt (from position 384, 384 positions of history in the cache)
    inputs = {"tokens": requests[int(np.argmax(lens))][0]["tokens"].cuda()}
    with torch.no_grad():
        h, pcaches = engine.prefill_begin(cfg, packed, inputs, cap)
        for c0 in range(0, 384, 128):
            engine.prefill_step(cfg, packed, h[:, c0:c0 + 128], c0, pcaches)
        device_breakdown(lambda: engine.prefill_step(
            cfg, packed, h[:, 384:512], 384, pcaches),
            f"prefill chunk [384, {h.shape[1]})", top=8)
    del h, pcaches

    # against the static engine at batch 1 (m 1, where the tick runs m 8:
    # w4a16_matmul's tiles and k splits differ), eager steps of its loop
    for i in (0, 1):
        b, m = requests[i]
        inputs = {"tokens": b["tokens"].cuda()}
        n0 = inputs["tokens"].shape[1]
        lg, caches = engine.prefill(cfg, packed, inputs, n0 + m + 1)
        loop = engine.DecodeLoop(cfg, packed, lg, caches, n0, m, -1, 0.0,
                                 None)
        gaps = [lg]
        for _ in range(m - 1):
            gaps.append(loop.step().clone())
        static = loop.tokens[0].tolist()
        cont = done[rids[i]].tokens.tolist()
        j = next((k for k, (a, c) in enumerate(zip(static, cont)) if a != c),
                 None)
        if j is None:
            log(f"  request {i} against the static engine at batch 1: all "
                f"{m} tokens equal")
        else:
            top2 = torch.topk(gaps[j][0].float(), 2).values
            log(f"  request {i} against the static engine at batch 1: first "
                f"divergent token at step {j} of {m} (static {static[j]}, "
                f"continuous {cont[j]}); the static logits' top-2 gap there "
                f"{float(top2[0] - top2[1]):.4g}")
        del loop, caches, gaps

    # chunked against single-shot prefill: fp32 compute on a fp32 cache
    mdt = dataclasses.replace(mc, dtype="float32")
    toks = requests[int(np.argmax(lens))][0]["tokens"].cuda()
    l1, c1 = T.prefill(mdt, packed, toks, cap, torch.float32)
    l2, c2 = T.prefill_chunked(mdt, packed, toks, cap, 128, torch.float32)
    rel = float((l2 - l1).norm() / l1.norm())
    del c1, c2
    log(f"  chunked (128) against single-shot prefill of {toks.shape[1]} "
        f"tokens, fp32 compute and cache: logits rel {rel:.3e} (tol 1e-4)")
    check(rel <= 1e-4, "chunked against single-shot prefill")

    # the replayed tick against the eager tick, and row independence, on
    # a fresh engine with every lane busy
    eng2 = ContinuousEngine(cfg, packed, max_len=cap)
    for b, m in requests[:8]:
        eng2.submit(b, max_new_tokens=64)
    while eng2.active < eng2.lanes or eng2._graph is None:
        eng2.step()
    leaves = list(T.cache_leaves(eng2._caches))
    base = [a.clone() for a in leaves]
    eng2._graph.replay()
    replayed = [x.clone() for x in eng2._graph.out]
    after = [a.clone() for a in leaves]
    for dst, src in zip(leaves, base):
        dst.copy_(src)
    eager_out = eng2._guarded_step()
    bitwise = all(torch.equal(a, b) for a, b in zip(eager_out, replayed)) \
        and all(torch.equal(a, b) for a, b in zip(leaves, after))
    tok = eng2._tok_dev.clone()

    def replay_with(lane0_from: int, tok0: int):
        for dst, src in zip(leaves, base):
            dst.copy_(src)
            dst[0].copy_(src[lane0_from])
        eng2._tok_dev.copy_(tok)
        eng2._tok_dev[0] = tok0
        eng2._graph.replay()
        return [x.clone() for x in eng2._graph.out]

    want = replay_with(0, int(tok[0]))
    got = replay_with(3, (int(tok[0]) + 7) % mc.vocab_size)
    independent = all(torch.equal(a[1:], b[1:]) for a, b in zip(got, want))
    changed = not torch.equal(got[0][:1], want[0][:1])
    log(f"  the replayed tick bitwise the eager tick (tokens, flags, "
        f"caches): {bitwise}; lane 0 given lane 3's history and another "
        f"token: lanes 1-7 bitwise unchanged {independent} (lane 0's "
        f"token changed {changed})")
    del eng2, leaves, base, after
    check(bitwise and independent, "the tick's graph and row independence")

    # quarantine: the poisoned lane only
    eng3 = ContinuousEngine(cfg, packed, max_len=cap)
    q = drive_continuous(eng3, requests, "serve.decode_step@40")
    hit = [r for r in q["rids"] if q["done"][r].status == "quarantined"]
    others = [i for i, r in enumerate(q["rids"]) if r not in hit]
    same = all(q["done"][q["rids"][i]].tokens.tolist()
               == done[rids[i]].tokens.tolist() for i in others)
    log(f"  serve.decode_step@40: quarantined {len(hit)} request(s) "
        f"{hit}; the other {len(others)} requests' tokens bitwise the "
        f"fault-free run's: {same}; stats {eng3.engine_stats()}")
    del eng3
    check(len(hit) == 1 and same and all(
        q["done"][q["rids"][i]].status == "ok" for i in others),
        "quarantine isolation")

    # a crash under the supervisor
    sup = SupervisedEngine(cfg, packed, max_len=cap)
    k = drive_continuous(sup, requests, "serve.engine_step@60")
    fin = [k["done"][r] for r in k["rids"]]
    complete = all(f.status == "ok" and f.steps == m
                   for f, (_, m) in zip(fin, requests))
    identical = sum(f.tokens.tolist() == done[r].tokens.tolist()
                    for f, r in zip(fin, rids))
    log(f"  serve.engine_step@60 under SupervisedEngine: every request ok "
        f"at its budget {complete}; token-identical to the fault-free run "
        f"{identical} of {n_req} (reported, not held); {k['ticks']} ticks "
        f"in {k['wall']:.3f}s; stats {sup.engine_stats()}")
    check(complete and sup.engine_stats()["restarts"] == 1,
          "supervisor recovery at full width")
    del sup, eng, packed
    return launches


def recording_plans(plans: list):
    """A wrapper maker for ``patched`` on ``moe.route``: each routing plan
    made is appended to ``plans``."""
    def make(fn):
        def wrapper(*args, **kwargs):
            plans.append(fn(*args, **kwargs))
            return plans[-1]
        return wrapper
    return make


def replaying_plans(plans: list):
    """A wrapper maker for ``patched`` on ``moe.route``: each call returns
    the next of ``plans`` (recorded by ``recording_plans``) instead of
    routing."""
    def make(fn):
        def wrapper(*args, **kwargs):
            return plans.pop(0)
        return wrapper
    return make


def tensors_of(tree):
    """Every tensor of a param tree (a QuantizedTensor's three), dict keys
    in sorted order."""
    import torch
    from repro_torch.core.quant import QuantizedTensor
    if isinstance(tree, QuantizedTensor):
        yield from (tree.packed, tree.scales, tree.zeros)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensors_of(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from tensors_of(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def recording_starts(starts: list):
    """A wrapper maker for ``patched`` on ``engine.DecodeLoop``: each loop
    built appends its lanes' first decode positions to ``starts``."""
    def make(loop_cls):
        class Loop(loop_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                starts.append(self.pos.tolist())
        return Loop
    return make


def timed(walls: list, sync: bool = True):
    """A wrapper maker for ``patched``: each call's wall (the device
    synchronised after it where ``sync``) is appended to ``walls``."""
    import torch

    def make(fn):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            return out
        return wrapper
    return make


def run_launcher(mod, argv: list, launches: dict):
    """``mod.main(argv)`` in this process with the launch counters reset
    just before and read just after (added to ``launches``, also when
    main raises); returns (main's result, its wall, its counts)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    try:
        out = mod.main(argv)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t
        counts = ops.kernel_launches()
        for k, n in counts.items():
            launches[k] += n
        log(f"  launches: {json.dumps(counts)}")
    return out, wall, counts


def serve_walls(mod, argv: list, launches: dict, label: str, smi: str):
    """``launch.serve`` through ``run_launcher``, with the prefill and the
    replays of the captured decode step timed (device synchronised);
    prints serve total, prefill, capture and replayed step beside the
    card."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine
    pre, rep = [], []
    with patched(engine, "prefill", timed(pre)), \
            patched(ops.CapturedCall, "replay", timed(rep)):
        res, wall, counts = run_launcher(mod, argv, launches)
    steps = res.tokens.shape[1] - 2
    log(f"  walls (s) [{smi}]: {label} serve total {wall:.3f}, prefill "
        f"{pre[0]:.4f}, capture {res.capture_s:.4f}, replayed step "
        f"{rep[0] / steps:.5f} (mean of {steps})")
    return res, counts


def diff_artifacts(got_path: str, want_path: str) -> bool:
    """Whether two artifacts hold the same leaves bitwise; where they do
    not, prints the leaves that differ (in layer order), the share of
    their cells that differ and the first leaf where a difference
    enters."""
    import numpy as np
    from repro_torch.distributed.checkpoint import load_artifact, tree_paths
    got = dict(tree_paths(load_artifact(got_path)))
    want = dict(tree_paths(load_artifact(want_path)))
    if list(got) != list(want):
        log(f"  leaves differ in name: {sorted(set(got) ^ set(want))[:8]}")
        return False

    def order(name):
        parts = name.split("/")
        return [int(p) if p.isdigit() else -1 for p in parts[:2]], name

    bad = []
    for name in sorted(got, key=order):
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append((name, 1.0))
        elif not np.array_equal(a.view(np.uint8) if a.ndim else a,
                                b.view(np.uint8) if b.ndim else b):
            bad.append((name, float((a != b).mean())))
    for name, share in bad[:12]:
        log(f"  differs: {name}: share of cells {share:.3e}")
    if bad:
        log(f"  {len(bad)} of {len(got)} leaves differ; the first "
            f"difference enters at {bad[0][0]}")
    return not bad


# phase 8a's stage-2 count on random weights, which phase 16 reads beside
# the trained model's: {arch: (linears stage 2 improved, linears)}
RANDOM_STAGE2: dict = {}


def stage2_improved(report) -> int:
    """Linears whose final Γ is under 0.999 of their post-stage-1 Γ (the
    count ``QuantReport.summary`` prints)."""
    return sum(1 for r in report.linears
               if r.gamma and r.gamma_final < r.gamma[0] * 0.999)


def phase_entry_points(table: KernelTable, smi: str) -> dict:
    """The launchers' ``main(argv)`` in this process on the card, each
    with the launch counters reset and read around it (8a-8e in the module
    docstring); artifacts and checkpoints under build/phase8, removed at
    the end. Returns the launches summed over the launcher runs."""
    import hashlib
    import io
    import pickle
    import runpy
    import shutil
    import torch
    from repro_torch.config import apply_overrides, parse_overrides
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_to_numpy
    from repro_torch.core import plan as qplan
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.distributed import checkpoint as C
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as LQ
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    launches = {k: 0 for k in KERNEL_SOURCES}
    root = os.path.join(ROOT, "build", "phase8")
    shutil.rmtree(root, ignore_errors=True)
    no_train = os.path.join(root, "no_train_ckpt")
    os.makedirs(no_train)

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    try:
        # -- 8a: launch.quantize at the launcher's calibration, then serve
        log("  8a: launch.quantize --arch opt-proxy (full width, "
            "calibration 8 x 16 x 512), then launch.serve --params")
        cfg = get_config("opt-proxy")
        mc, qc = cfg.model, cfg.quant
        n_cal = qc.calib_batch_size * min(qc.calib_seq_len,
                                          mc.max_seq_len - 8)
        qargs = ["--arch", "opt-proxy", "--out", os.path.join(root, "a"),
                 f"train.ckpt_dir={no_train}"]
        saves = []
        with patched(LQ, "save_artifact", timed(saves)):
            (path, report), q_wall, _ = run_launcher(LQ, qargs, launches)
        RANDOM_STAGE2["opt-proxy"] = (stage2_improved(report),
                                      len(report.linears))
        rest = report.seconds_total - report.seconds_stage1 \
            - report.seconds_stage2
        art_bytes = os.path.getsize(path)
        log(f"  walls (s) [{smi}]: launch.quantize total {q_wall:.3f}; "
            f"quantize_model {report.seconds_total:.3f} (stage1 "
            f"{report.seconds_stage1:.3f} stage2 {report.seconds_stage2:.3f}"
            f" capture+propagate+rest {rest:.3f}; stage 2 at n={n_cal}); "
            f"artifact {art_bytes} bytes, save_artifact {saves[0]:.3f}")
        loads = []
        with patched(LS, "load_artifact", timed(loads, sync=False)):
            res_a, _ = serve_walls(LS, ["--arch", "opt-proxy", "--params",
                                        path], launches, "opt-proxy --params",
                                   smi)
        log(f"  walls (s) [{smi}]: load_artifact {loads[0]:.3f} "
            f"({art_bytes} bytes, sha256 checked)")

        # the same walk called directly on the same seeded weights and
        # batches (not counted); layer 0's stage-2 calls at the launcher's
        # n held against the plain version at phase 3's pins
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = T.init_params(mc, gen, "cuda")
        calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7),
                                    qc.calib_batches, qc.calib_batch_size,
                                    min(qc.calib_seq_len,
                                        mc.max_seq_len - 8))
        layer0 = []

        def keep_layer0(fn):
            def wrapper(*args, **kwargs):
                if len(layer0) < 3:     # opt-proxy's three groups a layer
                    # raw64 (fp64 partials for a row shard's sum) is the
                    # wrapper's alone: the plain version sums in fp32
                    layer0.append((tuple(a.clone() for a in args),
                                   {k: v for k, v in kwargs.items()
                                    if k != "raw64"}))
                return fn(*args, **kwargs)
            return wrapper

        with patched(ops, "rpiq_block_cuda", keep_layer0):
            params_q, _ = quantize_model(cfg, params, calib)
        del params
        packed = pack_for_serving(cfg, params_q)
        del params_q
        direct = hashlib.sha256(pickle.dumps(
            tree_to_numpy(packed),
            protocol=pickle.HIGHEST_PROTOCOL)).hexdigest()
        with open(C.artifact_manifest_path(path)) as f:
            side = json.load(f)["sha256"]
        prompt = MarkovLM(mc.vocab_size, seed=3).batch(4, 16)
        res_d = generate(cfg, packed, prompt)
        same_art = direct == side == sha(path)
        same_tok = bool(torch.equal(res_a.tokens, res_d.tokens))
        log(f"  artifact bitwise that of quantize_model -> "
            f"pack_for_serving called directly (sha256 of the payload, the "
            f"sidecar's and the file's): {same_art}; launch.serve's tokens "
            f"equal generate's on it: {same_tok}")
        log(f"  decoded tokens (request 0): {res_a.tokens[0].tolist()}")
        del packed
        for rargs, rkw in layer0:
            check_rpiq_call(rargs, rkw, table, label=" (launcher, layer 0)")
        del layer0
        g8 = torch.Generator(device="cuda")
        g8.manual_seed(8192)
        for d in (768, 3072):
            check_hessian_accum(table, g8, n_cal, d)

        bad = os.path.join(root, "flipped.params.pkl")
        shutil.copy(path, bad)
        shutil.copy(C.artifact_manifest_path(path),
                    C.artifact_manifest_path(bad))
        with open(bad, "r+b") as f:
            f.seek(art_bytes // 2)
            byte = f.read(1)[0]
            f.seek(art_bytes // 2)
            f.write(bytes([byte ^ 0x01]))
        try:
            LS.main(["--arch", "opt-proxy", "--params", bad])
            refused = "nothing"
        except C.ArtifactIntegrityError as e:
            refused = f"ArtifactIntegrityError ({str(e)[-60:]})"
        log(f"  launch.serve --params on a copy with one flipped byte "
            f"raised: {refused}")
        check(same_art and same_tok
              and refused.startswith("ArtifactIntegrityError"),
              "8a: launcher artifact and tokens bitwise the direct calls', "
              "a flipped byte refused")

        # -- 8b: the same run checkpointed, interrupted after step 6 of
        # 12, then resumed with quant.resume=auto
        log("  8b: the same launch.quantize with quant.ckpt_dir and "
            "quant.resume=auto, interrupted after step 6 of 12, resumed")
        ck = [f"quant.ckpt_dir={os.path.join(root, 'ck')}",
              "quant.resume=auto"]
        bargs = ["--arch", "opt-proxy", "--out", os.path.join(root, "b"),
                 f"train.ckpt_dir={no_train}"] + ck

        class Interrupted(Exception):
            pass

        def stop_at_step_7(fn):
            calls = []

            def wrapper(*args, **kwargs):
                calls.append(1)
                if len(calls) == 7:
                    raise Interrupted("interrupted at step 7")
                return fn(*args, **kwargs)
            return wrapper

        ckpt_walls = []
        t = time.perf_counter()
        with patched(C.Checkpointer, "save", timed(ckpt_walls, sync=False)):
            with patched(qplan, "execute_plan", stop_at_step_7):
                try:
                    run_launcher(LQ, bargs, launches)
                    interrupted = False
                except Interrupted:
                    interrupted = True
            latest = C.Checkpointer(os.path.join(root, "ck")).latest_step()
            (path_b, report_b), resumed_wall, _ = run_launcher(
                LQ, bargs, launches)
        first_wall = time.perf_counter() - t - resumed_wall
        same_b = sha(path_b) == sha(path)
        log(f"  interrupted {interrupted}; latest checkpoint step {latest} "
            f"(0-based); resumed at walk item "
            f"{report_b.pipeline_stats.get('resumed_at')}; resumed "
            f"artifact's sha256 equal to 8a's: {same_b}")
        log(f"  walls (s) [{smi}]: interrupted run {first_wall:.3f}, "
            f"resumed run {resumed_wall:.3f}; checkpoint save per step "
            f"(host copy + crc32 + joining the previous write) mean "
            f"{sum(ckpt_walls) / len(ckpt_walls):.3f} max "
            f"{max(ckpt_walls):.3f} over {len(ckpt_walls)} steps")
        if not same_b:
            diff_artifacts(path_b, path)
        shutil.rmtree(os.path.join(root, "ck"), ignore_errors=True)
        check(interrupted and latest == 5
              and report_b.pipeline_stats.get("resumed_at") == 6 and same_b,
              "8b: the resumed artifact bitwise the uninterrupted one")

        # -- 8c / 8d: launch.serve --pack-rtn at full width
        for label, arch, extra, kv_calls in (
                ("8c", "internlm2-1.8b", ["serve.kv_cache=int8"], True),
                ("8d", "falcon-mamba-7b", ["model.num_layers=8"], False)):
            log(f"  {label}: launch.serve --arch {arch} --pack-rtn "
                f"{' '.join(extra)} (4 requests x 512 prompt + 32 new)")
            argv = ["--arch", arch, "--pack-rtn", "--batch", "4",
                    "--prompt-len", "512"] + extra
            res, counts = serve_walls(LS, argv, launches, arch, smi)
            cfg = get_config(arch)
            apply_overrides(cfg, parse_overrides(extra))
            mc = cfg.model
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            packed = pack_for_serving(cfg, T.init_params(mc, gen, "cuda"))
            res_d = generate(cfg, packed, MarkovLM(mc.vocab_size, seed=3)
                             .batch(4, 512))
            del packed
            same = bool(torch.equal(res.tokens, res_d.tokens))
            finite = bool(torch.isfinite(res.logprobs).all())
            want = {"quant_pack": counts["quant_pack"] > 0,
                    "w4a16_matmul": counts["w4a16_matmul"] > 0}
            if kv_calls:
                want["int8_kv_attention"] = (counts["int8_kv_attention"]
                                             == mc.num_layers * 31)
            else:
                want["selective_scan"] = (counts["selective_scan"]
                                          == mc.num_layers)
            log(f"  tokens equal pack_for_serving -> generate called "
                f"directly: {same}; logprobs finite {finite}; launch "
                f"checks {want}; decoded tokens (request 0): "
                f"{res.tokens[0].tolist()}")
            check(same and finite and all(want.values())
                  and tuple(res.tokens.shape) == (4, 32),
                  f"{label}: launch.serve --arch {arch}")

        # -- 8e: the two example twins on the card
        for script, pattern in (
                ("torch_quickstart.py",
                 "packed int4 vs refined-grid float: rel err"),
                ("torch_quantize_and_serve.py", "request 3: prompt=")):
            log(f"  8e: examples/{script}")
            out = io.StringIO()
            argv = sys.argv
            sys.argv = [script]
            ops.reset_kernel_launches()
            try:
                with contextlib.redirect_stdout(out):
                    runpy.run_path(os.path.join(ROOT, "examples", script),
                                   run_name="__main__")
            finally:
                sys.argv = argv
            counts = ops.kernel_launches()
            for k, n in counts.items():
                launches[k] += n
            text = out.getvalue()
            for ln in text.splitlines():
                log(f"    {ln}")
            log(f"  launches: {json.dumps(counts)}")
            ok = pattern in text and "MISMATCH" not in text and (
                "(OK)" in text if script == "torch_quickstart.py" else True)
            check(ok and counts["w4a16_matmul"] > 0, f"8e: {script}")

        # -- 8f: 8a's command under the overlap schedule
        log("  8f: 8a's launch.quantize with quant.pipeline=overlap")
        fargs = ["--arch", "opt-proxy", "--out", os.path.join(root, "f"),
                 f"train.ckpt_dir={no_train}", "quant.pipeline=overlap"]
        (path_f, report_f), f_wall, _ = run_launcher(LQ, fargs, launches)
        same_f = sha(path_f) == sha(path)
        log(f"  walls (s) [{smi}]: launch.quantize overlap {f_wall:.3f} "
            f"(8a serial {q_wall:.3f}); pipeline "
            f"{json.dumps(report_f.pipeline_stats)}; artifact's sha256 "
            f"equal to 8a's: {same_f}")
        if not same_f:
            diff_artifacts(path_f, path)
        check(same_f and report_f.pipeline_stats["spec_captures"] == 11,
              "8f: the overlap artifact bitwise the serial one")

        # -- 8g: killed by the fault plane under overlap, resumed without
        # the arming (the fingerprint ignores faults.*)
        log("  8g: the overlap run with quant.ckpt_dir, killed by "
            "faults.arm=plan.stage1_executor@19, resumed without it")
        from repro_torch.core import faults
        gck = [f"quant.ckpt_dir={os.path.join(root, 'gck')}",
               "quant.resume=auto"]
        gargs = ["--arch", "opt-proxy", "--out", os.path.join(root, "g"),
                 f"train.ckpt_dir={no_train}",
                 "quant.pipeline=overlap"] + gck
        try:
            run_launcher(LQ, gargs + ["faults.arm=plan.stage1_executor@19"],
                         launches)
            killed = "nothing"
        except faults.FaultError as e:
            killed = str(e)
        finally:
            faults.PLANE.disarm()   # the launcher leaves the plane armed
        (path_g, report_g), g_wall, _ = run_launcher(LQ, gargs, launches)
        same_g = sha(path_g) == sha(path)
        log(f"  killed: {killed}; resumed at walk item "
            f"{report_g.pipeline_stats.get('resumed_at')}; resumed run "
            f"{g_wall:.3f} s [{smi}]; artifact's sha256 equal to 8a's: "
            f"{same_g}")
        if not same_g:
            diff_artifacts(path_g, path)
        check(killed.startswith("injected fault at 'plan.stage1_executor'")
              and report_g.pipeline_stats.get("resumed_at") == 6 and same_g,
              "8g: the fault-killed overlap run resumed to 8a's artifact")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def streams_of_kernel(prof, name: str) -> dict:
    """{CUDA stream id: launches} of the kernels whose name holds ``name``
    in a finished ``torch.profiler`` run (the events' device resource is
    their stream)."""
    import torch
    out: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.name):
            sid = getattr(e, "device_resource_id", None)
            out[sid] = out.get(sid, 0) + 1
    return out


def phase_overlap_path(smi: str) -> dict:
    """15: the overlap schedule at full width and depth (module
    docstring): olmoe-1b-7b and internlm2-1.8b on the weights and
    calibration of phases 11 and 6, held against their serial runs there;
    then a 2-layer cut of each under ``torch.profiler``. Returns the
    launches of the two full-depth overlap runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    launches = {k: 0 for k in KERNEL_SOURCES}

    def setup(arch, calib_shape, layers=0):
        cfg = get_config(arch)
        cfg.quant.pipeline = "overlap"
        mc = cfg.model
        if layers:
            mc.num_layers = layers
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = T.init_params(mc, gen, "cuda")
        calib = [with_frontend(mc, b, 20 + i, "cuda") for i, b in enumerate(
            calibration_batches(MarkovLM(mc.vocab_size, seed=7),
                                *calib_shape))]
        return cfg, params, calib

    for arch, calib_shape, phase in (("olmoe-1b-7b", (4, 4, 512), 11),
                                     ("internlm2-1.8b", (4, 4, 128), 6)):
        serial = SERIAL_RUNS[arch]
        torch.cuda.synchronize()
        release_device()
        held_before = torch.cuda.memory_allocated()
        cfg, params, calib = setup(arch, calib_shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        params_q, report = quantize_model(cfg, params, calib)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held_before
        del params
        packed = pack_for_serving(cfg, params_q)
        del params_q
        counts = ops.kernel_launches()
        for k, n in counts.items():
            launches[k] += n
        digests = leaf_digests(packed)
        del packed
        n_same = sum(a == b for a, b in zip(digests, serial["leaves"]))
        same_report = report_digest(report) == serial["report"]
        st = report.pipeline_stats
        steps = sum(report.layer_step_seconds)
        log(f"  {arch} (calibration {calib_shape}): launches "
            f"{json.dumps(counts)}")
        log(f"  pipeline_stats: {json.dumps(st)}")
        log(f"  walls (s) [{smi}]: quantize_model serial (phase {phase}) "
            f"{serial['wall']:.3f}, overlap {wall:.3f} "
            f"({wall / serial['wall']:.4f}x); summed layer steps serial "
            f"{serial['steps']:.3f}, overlap {steps:.3f}; overlap stage "
            f"seconds (dispatch) s1={report.seconds_stage1:.3f} "
            f"s2={report.seconds_stage2:.3f}")
        log(f"  quantization peak (bytes, this path): serial {serial['peak']}"
            f", overlap {peak} ({peak - serial['peak']:+d}); held by earlier "
            f"phases {held_before}")
        log(f"  packed leaves whose sha256 equals phase {phase}'s serial "
            f"run: {n_same} of {len(serial['leaves'])} (overlap has "
            f"{len(digests)}); report equal (modes, iterations, Γ "
            f"histories, capacity drops): {same_report}")
        check(len(digests) == len(serial["leaves"]) == n_same > 0
              and same_report and st["mode"] == "overlap"
              and st["spec_captures"] == st["repairs"] == st["steps"] - 1
              and st["serial_fallbacks"] == st["fallback_flip_budget"]
              and counts["hessian_accum"] > 0,
              f"15: {arch} under overlap bitwise its serial run")

        # a 2-layer cut under the profiler: the first step captures the
        # second ahead, its hessian_accum launches on the side stream
        cfg, params, calib = setup(arch, calib_shape, layers=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params_q2, rep2 = quantize_model(cfg, params, calib)
            torch.cuda.synchronize()
        # the cut's quantized tree must not outlive its leg (it held
        # 5.6 GB through the next one)
        del params, calib, params_q2
        by_stream = streams_of_kernel(prof, "hessian_accum")
        log(f"  2-layer cut under torch.profiler: hessian_accum kernels by "
            f"CUDA stream {by_stream}; spec_captures "
            f"{rep2.pipeline_stats['spec_captures']}")
        check(len([k for k in by_stream if k is not None]) == 2
              and rep2.pipeline_stats["spec_captures"] == 1,
              f"15: {arch}'s speculative hessian_accum on a second stream")
        release_device()
    return launches


def _train_argv(ck: str, steps: int) -> list:
    """16a's ``launch.train`` command line: full-width opt-proxy, batch 16
    x 128, lr 1e-3, a checkpoint every 150 steps (each writes ~2 GB:
    params and two moments), no remat (the step is host-bound; remat adds
    about a third to its wall). The corpus is the launcher's
    ``MarkovLM`` with 3 successors a token (``Branch3``)."""
    return ["--arch", "opt-proxy", f"train.ckpt_dir={ck}", f"train.steps={steps}",
            "train.global_batch_size=16", "train.seq_len=128",
            "train.lr=1e-3", "train.ckpt_every=150", "train.log_every=50",
            "parallel.remat=none"]


def profile_train_steps(cfg, batches, label: str) -> None:
    """A fresh state of ``cfg`` on the card, one warm step on
    ``batches[0]``, then one step on ``batches[1]`` through
    ``device_breakdown`` (wall, the kernels' device time, idle share)."""
    import torch
    from repro_torch.training import train_step as TS
    st = TS.init_train_state(cfg, torch.device("cuda"))
    step = TS.make_train_step(cfg)
    st, m = step(st, batches[0])
    float(m["loss"])
    device_breakdown(lambda: float(step(st, batches[1])[1]["loss"]), label)


def _mean(xs) -> float:
    return sum(xs) / len(xs)


def phase_training_path(smi: str) -> dict:
    """16: training on the card (module docstring): 16a full-width
    opt-proxy through ``launch.train`` in this process (uninterrupted; a
    second run stopped by SIGTERM half-way and rerun, its final
    checkpoint bitwise the first's), ``launch.quantize
    train.ckpt_dir=`` on the trained checkpoint (stage 2's count beside
    phase 8a's on random weights; held-out CE of the float, RPIQ int4 and
    RTN int4 models and the logit gap), ``launch.serve --params``; 16b
    internlm2-1.8b at full width and depth, five steps at 4 x 512 under
    full remat with fp32 and with int8 moments; 16c falcon-mamba-7b
    trained through the scan's backward kernel (``phase_mamba_training``).
    Returns the launches of 16a's quantize, eval and serve and 16c's
    launch.train."""
    import shutil
    import signal
    import torch
    from repro_torch.config import apply_overrides, parse_overrides
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, unstack_layers
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import DataState, MarkovLM
    from repro_torch.distributed.checkpoint import (Checkpointer,
                                                    load_artifact, tree_paths)
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize as LQ
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS

    class Branch3(MarkovLM):
        """The launcher's corpus with 3 successors a token (the example
        twin's), the rest as the launcher builds it."""
        def __init__(self, vocab_size, seed=0):
            super().__init__(vocab_size, seed=seed, branching=3)

    launches = {k: 0 for k in KERNEL_SOURCES}
    root = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    steps, kill_at = 150, 77
    ck_a, ck_b = os.path.join(root, "a"), os.path.join(root, "b")
    try:
        # -- 16a: uninterrupted, in this process
        log(f"  16a: launch.train --arch opt-proxy (12 layers, d 768, vocab "
            f"50304; fp32 master, bf16 compute, no remat) {steps} steps "
            "of 16 x 128 tokens, lr 1e-3, MarkovLM(branching=3)")
        torch.cuda.synchronize()
        release_device()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with patched(LT, "MarkovLM", lambda make: Branch3):
            out, wall, counts = run_launcher(LT, _train_argv(ck_a, steps),
                                             launches)
        peak = torch.cuda.max_memory_allocated() - held
        hist, a_state = out["history"], out["state"]
        del out
        losses = [h["loss"] for h in hist]
        dts = sorted(h["dt"] for h in hist[1:])
        first, last = _mean(losses[:10]), _mean(losses[-10:])
        log(f"  walls (s) [{smi}]: launch.train {wall:.3f}; step median "
            f"{dts[len(dts) // 2]:.5f}, quartiles {dts[len(dts) // 4]:.5f}"
            f" / {dts[3 * len(dts) // 4]:.5f}, first step "
            f"{hist[0]['dt']:.3f} ({2048 / dts[len(dts) // 2]:.0f} tokens/s"
            f" at the median); peak above what was held {peak} bytes "
            f"(held {held})")
        log(f"  loss: mean of steps 0-9 {first:.4f}, of steps "
            f"{steps - 10}-{steps - 1} {last:.4f}; step 0 {losses[0]:.4f},"
            f" step {steps - 1} {losses[-1]:.4f}; grad_norm step "
            f"{steps - 1} {hist[-1]['grad_norm']:.4f}; kernel launches "
            f"{counts}")
        check(len(hist) == steps and all(math.isfinite(x) for x in losses)
              and last < first - 0.5, "16a: the loss falls")
        data = MarkovLM(50304, seed=0, branching=3)
        cfg = get_config("opt-proxy")
        apply_overrides(cfg, parse_overrides(_train_argv(ck_a, steps)[2:]))
        profile_train_steps(cfg, [data.batch(16, 128) for _ in range(2)],
                            "16a train step")
        release_device()

        # -- the same run again, SIGTERM half-way, then rerun. The stream
        # sends this process SIGTERM as it makes batch ``kill_at`` (in the
        # trainer's prefetch thread, which runs up to three batches ahead
        # of the steps, under the trainer's handler); the trainer stops at
        # the next step boundary with a checkpoint
        class Killing(Branch3):
            def batch(self, *a, **kw):
                if self.step == kill_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return super().batch(*a, **kw)

        with patched(LT, "MarkovLM", lambda make: Killing):
            halted, wall, _ = run_launcher(LT, _train_argv(ck_b, steps),
                                          launches)
        stopped = Checkpointer(ck_b).latest_step()
        log(f"  SIGTERM as batch {kill_at} was made: the run stopped after "
            f"step {halted['history'][-1]['step']}, latest checkpoint step "
            f"{stopped} ({wall:.1f}s)")
        check(kill_at - 4 < stopped <= kill_at
              and stopped == len(halted["history"]), "16a: SIGTERM "
              "checkpoints at the next step boundary")
        del halted
        with patched(LT, "MarkovLM", lambda make: Branch3):
            again, wall, _ = run_launcher(LT, _train_argv(ck_b, steps),
                                          launches)
        log(f"  rerun: steps {again['history'][0]['step']}"
            f"-{again['history'][-1]['step']} ({wall:.1f}s)")
        check([h["step"] for h in again["history"]]
              == list(range(stopped, steps)), "16a: the rerun resumes")
        want = dict(tree_paths(a_state))
        got = dict(tree_paths(again["state"]))
        del again
        differ = [k for k in want if not torch.equal(got[k], want[k])]

        def extra(ck):
            with open(os.path.join(ck, f"step_{steps:09d}",
                                   "manifest.json")) as f:
                return json.load(f)["extra"]
        log(f"  resumed final TrainState against the uninterrupted one: "
            f"{len(want) - len(differ)} of {len(want)} leaves bitwise "
            f"equal; data stream {extra(ck_b)} / {extra(ck_a)}")
        for k in differ[:8]:
            a, b = got[k].double(), want[k].double()
            log(f"  differs: {k}: rel {float((a - b).norm() / b.norm()):.3e}")
        check(not differ and got.keys() == want.keys()
              and extra(ck_b) == extra(ck_a), "16a: the resumed run is "
              "bitwise the uninterrupted one")
        del got, want

        # -- quantize the trained checkpoint, evaluate, serve
        qdir = os.path.join(root, "q")
        (path, report), q_wall, _ = run_launcher(
            LQ, ["--arch", "opt-proxy", "--out", qdir,
                 f"train.ckpt_dir={ck_a}"], launches)
        improved, n_lin = stage2_improved(report), len(report.linears)
        rnd = RANDOM_STAGE2.get("opt-proxy")
        log(f"  walls (s) [{smi}]: launch.quantize on the trained "
            f"checkpoint {q_wall:.3f}; quantize_model "
            f"{report.seconds_total:.3f} (stage1 {report.seconds_stage1:.3f}"
            f" stage2 {report.seconds_stage2:.3f})")
        log(f"  stage 2 improved {improved} of {n_lin} linears on the "
            f"trained weights (phase 8a, random weights, same calibration: "
            f"{rnd[0] if rnd else 'not run'} of "
            f"{rnd[1] if rnd else n_lin}); modes "
            f"{sorted(set(r.mode for r in report.linears))}")
        gammas = sorted((r.gamma_final / r.gamma[0], r.name)
                        for r in report.linears if r.gamma)
        log(f"  Γ final / Γ after stage 1: best {gammas[0][0]:.4f} "
            f"({gammas[0][1]}), median {gammas[len(gammas) // 2][0]:.4f}")

        cfg = get_config("opt-proxy")
        mc = cfg.model
        trained = unstack_layers(a_state.params)
        packed = params_from_numpy(load_artifact(path), "cuda")
        rtn = pack_for_serving(cfg, trained)
        held_out = MarkovLM(mc.vocab_size, seed=0, branching=3)
        held_out.restore(DataState(0, 1_000_000))
        batches = [held_out.batch(16, 128)["tokens"].cuda()
                   for _ in range(4)]
        ops.reset_kernel_launches()
        ce, gap = {}, {}
        with torch.no_grad():
            for label, p in (("float", trained), ("rpiq int4", packed),
                             ("rtn int4", rtn)):
                vals = []
                for i, toks in enumerate(batches):
                    lg = T.forward(mc, p, toks)
                    vals.append(float(TS.cross_entropy(lg[:, :-1],
                                                       toks[:, 1:], None)))
                    if i == 0:
                        if label == "float":
                            ref = lg
                        else:
                            gap[label] = float((lg - ref).norm()
                                               / ref.norm())
                    del lg
                ce[label] = _mean(vals)
            del p
        counts = ops.kernel_launches()
        for k, n in counts.items():
            launches[k] += n
        log(f"  held-out CE (4 x 16 x 128 tokens at stream step 1e6, bf16 "
            f"compute): " + ", ".join(f"{k} {v:.4f}" for k, v in ce.items())
            + "; logit gap to float (rel, first batch): "
            + ", ".join(f"{k} {v:.4e}" for k, v in gap.items())
            + f"; launches {json.dumps(counts)}")
        check(all(math.isfinite(v) for v in ce.values())
              and ce["float"] < first - 0.5, "16a: the trained model's "
              "held-out CE")
        del trained, packed, rtn, ref, batches, a_state
        release_device()
        res, _ = serve_walls(LS, ["--arch", "opt-proxy", "--params", path,
                                  "--batch", "4", "--prompt-len", "16",
                                  "serve.max_new_tokens=16"], launches,
                             "opt-proxy trained --params", smi)
        log(f"  served tokens (request 0): {res.tokens[0].tolist()}")
        check(tuple(res.tokens.shape) == (4, 16), "16a: launch.serve "
              "--params on the trained artifact")
        del res
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- 16b: internlm2-1.8b at full width and depth
    moment_bytes = {}
    for int8 in (False, True):
        release_device()
        cfg = get_config("internlm2-1.8b")
        cfg.parallel.remat = "full"
        cfg.parallel.int8_optimizer_state = int8
        cfg.train.lr, cfg.train.warmup_steps, cfg.train.steps = 3e-4, 1, 5
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        st = TS.init_train_state(cfg, torch.device("cuda"))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        moment_bytes[int8] = O.state_bytes(st.opt)
        n_params = sum(p.numel() for p in O.tree_leaves(st.params))
        step = TS.make_train_step(cfg)
        data = MarkovLM(cfg.model.vocab_size, seed=0, branching=3)
        losses, walls = [], []
        for i in range(5):
            batch = data.batch(4, 512)
            t = time.perf_counter()
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() - held
        del st, m, step
        if not int8:
            release_device()
            profile_train_steps(cfg, [data.batch(4, 512) for _ in range(2)],
                                "16b train step (fp32 moments)")
        log(f"  16b: internlm2-1.8b ({n_params} parameters, fp32 master, "
            f"bf16 compute, remat full, {'int8' if int8 else 'fp32'} "
            f"moments): losses {[round(x, 4) for x in losses]}; walls (s) "
            f"[{smi}]: init {init_s:.3f}, steps "
            f"{[round(x, 4) for x in walls]}; optimizer state "
            f"{moment_bytes[int8]} bytes; peak above what was held {peak} "
            f"bytes (held {held})")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"16b: internlm2-1.8b's loss "
              f"falls ({'int8' if int8 else 'fp32'} moments)")
    ratio = moment_bytes[False] / moment_bytes[True]
    log(f"  optimizer state fp32 / int8: {ratio:.3f}x")
    check(ratio > 3.5, "16b: int8 moments ~4x smaller")

    # -- 16c: Mamba training on the card
    release_device()
    phase_mamba_training(smi, launches)
    release_device()
    return launches


# 16c: falcon-mamba-7b at full width, cut to 2 of its 64 layers, through
# launch.train (remat full, the launcher's default): steps of batch x seq
# tokens at lr (warmup 1)
MAMBA_TRAIN = dict(layers=2, steps=8, batch=4, seq=256, lr=1e-3)


def grads_against(got, want, pin: float = 1e-5) -> list:
    """The leaves of ``got`` farther than ``pin`` from ``want`` (relative
    norm per leaf, with tests/test_torch_training.py's floor for a leaf
    whose gradient is near zero: 1e-3 of the whole gradient's norm), as
    (path, relative error); pin 0 asks for bitwise equality. The norms are
    taken on ``want``'s device."""
    from repro_torch.distributed.checkpoint import tree_paths
    want = dict(tree_paths(want))
    got = dict(tree_paths(got))
    floor = 1e-3 * math.sqrt(sum(float(w.double().pow(2).sum())
                                 for w in want.values()))
    bad = []
    for k, w in want.items():
        g = got[k].to(w.device)
        if pin == 0:
            if not g.equal(w):
                bad.append((k, float((g.double() - w.double()).norm())))
            continue
        err = float((g.double() - w.double()).norm())
        scale = max(float(w.double().norm()), floor)
        if err > pin * scale:
            bad.append((k, err / scale))
    return bad


def phase_mamba_training(smi: str, launches: dict) -> None:
    """16c: Mamba training on the card through the scan's backward kernel.
    falcon-mamba-7b at full width (d_model 4096, d_inner 8192, n 16, vocab
    65024) cut to ``MAMBA_TRAIN['layers']`` layers trains through
    ``launch.train`` (the counters reset just before and read just after:
    ``selective_scan_bwd`` once a layer a step, the forward twice under
    remat); the loss on a held-out batch must fall (the launcher's seeded
    initial weights against the trained ones; the training losses are
    printed, not checked, as they swing from step to step). Then on
    the trained weights: the same
    batch's gradients twice, bitwise equal; in fp32 compute the gradients
    against the same step with ``ops.selective_scan`` swapped for the
    plain function (autograd through ``ref.selective_scan`` on the card),
    per leaf at 1e-5 of the leaf; falcon-mamba smoke's fp32 gradients on
    the card against the CPU's at the same pin."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataState, MarkovLM
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as LT
    from repro_torch.training import train_step as TS

    mt = MAMBA_TRAIN
    t0 = time.perf_counter()
    ck = os.path.join(ROOT, "build", "phase16c")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "falcon-mamba-7b", f"model.num_layers={mt['layers']}",
            f"train.steps={mt['steps']}",
            f"train.global_batch_size={mt['batch']}",
            f"train.seq_len={mt['seq']}", f"train.lr={mt['lr']}",
            "train.warmup_steps=1", "train.log_every=1",
            f"train.ckpt_dir={ck}"]
    log(f"  16c: launch.train {' '.join(argv)} (fp32 master, bf16 compute, "
        "remat full)")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd_events = []

    def timed_bwd(fn):
        # CUDA events around each launch of the scan's backward in the steps
        def call(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            bwd_events.append(ev)
            return out
        return call

    try:
        with patched(ops, "selective_scan_bwd_cuda", timed_bwd):
            out, wall, counts = run_launcher(LT, argv, launches)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() - held
    hist, state = out["history"], out["state"]
    del out
    losses = [h["loss"] for h in hist]
    layer_steps = mt["layers"] * mt["steps"]
    steps_s = sum(h["dt"] for h in hist)
    bwd_s = sum(a.elapsed_time(b) for a, b in bwd_events) / 1e3
    log(f"  16c: losses {[round(x, 4) for x in losses]}; step walls (s) "
        f"[{smi}] {[round(h['dt'], 4) for h in hist]}; launch.train "
        f"{wall:.3f} s (the steps {steps_s:.3f}, the rest: init and the "
        f"final checkpoint); peak above what was held {peak} bytes")
    log(f"  16c: selective_scan_bwd inside the steps (CUDA events) [{smi}]: "
        f"{len(bwd_events)} launches, {bwd_s * 1e3:.4f} ms in all, "
        f"{bwd_s * 1e3 / max(len(bwd_events), 1):.4f} ms each, "
        f"{bwd_s / steps_s:.4f} of the steps' wall")
    cfg = get_config("falcon-mamba-7b")
    cfg.model.num_layers = mt["layers"]
    held_out = MarkovLM(cfg.model.vocab_size, seed=cfg.train.seed)
    held_out.restore(DataState(cfg.train.seed, 1_000_000))
    batch = {"tokens": held_out.batch(mt["batch"], mt["seq"])["tokens"]
             .cuda()}
    with torch.no_grad():
        ce = [float(TS.loss_fn(cfg, p, batch)[0]) for p in (
            TS.init_train_state(cfg, torch.device("cuda")).params,
            state.params)]
    half = mt["steps"] // 2
    log(f"  16c: held-out CE ({mt['batch']} x {mt['seq']} tokens at stream "
        f"step 1e6): initial weights {ce[0]:.4f}, trained {ce[1]:.4f}; "
        f"training loss, mean of the first {half} steps "
        f"{sum(losses[:half]) / half:.4f}, of the last {half} "
        f"{sum(losses[-half:]) / half:.4f}")
    # the training losses swing by a tenth from step to step at this lr,
    # so the gate is the held-out batch: one loss of the initial weights
    # and one of the trained ones
    check(len(losses) == mt["steps"]
          and all(math.isfinite(x) for x in losses + ce) and ce[1] < ce[0],
          "16c: falcon-mamba's held-out loss falls")
    check(counts["selective_scan_bwd"] == layer_steps
          and counts["selective_scan"] == 2 * layer_steps,
          f"16c: selective_scan_bwd launched {counts['selective_scan_bwd']}"
          f" times (expected {layer_steps}: layers x steps), the forward "
          f"{counts['selective_scan']} (expected {2 * layer_steps})")

    # the same batch's gradients twice: bitwise
    batch = {"tokens": batch["tokens"][:2]}
    params = state.params
    del state
    g1, _ = TS.loss_and_grads(cfg, params, batch)
    g2, _ = TS.loss_and_grads(cfg, params, batch)
    differ = grads_against(g2, g1, 0.0)
    log(f"  16c: the same batch's gradients twice (bf16 compute): "
        f"{len(differ)} leaves differ ({time.perf_counter() - t0:.1f}s in)")
    check(not differ, "16c: the gradients repeat bitwise")
    del g1, g2

    # fp32 compute: the kernels against autograd through the plain scan
    cfg.model.dtype = "float32"
    ops.reset_kernel_launches()
    got, m_got = TS.loss_and_grads(cfg, params, batch)
    kern = ops.kernel_launches()
    with patched(ops, "selective_scan", lambda f: ref.selective_scan):
        want, m_want = TS.loss_and_grads(cfg, params, batch)
    bad = grads_against(got, want)
    loss_rel = abs(float(m_got["loss"]) - float(m_want["loss"])) / abs(
        float(m_want["loss"]))
    log(f"  16c: fp32 gradients, kernels against the plain scan on the "
        f"card: loss rel {loss_rel:.2e}; {len(bad)} leaves past 1e-5 "
        f"{[(k, f'{e:.2e}') for k, e in bad[:8]]}; kernel launches "
        f"{json.dumps(kern)} ({time.perf_counter() - t0:.1f}s in)")
    check(not bad and loss_rel <= 1e-5 and kern["selective_scan_bwd"]
          == mt["layers"], "16c: the scan's backward against the plain "
          "scan's autograd, per leaf")
    del got, want, params

    # falcon-mamba smoke: the card's fp32 gradients against the CPU's
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cfg.model.dtype = "float32"
    st = TS.init_train_state(cfg, "cpu")
    batch = MarkovLM(cfg.model.vocab_size, seed=0).batch(4, 32)
    want, m_want = TS.loss_and_grads(cfg, st.params, batch)
    on_card = TS.opt.tree_map(lambda a: a.cuda(), st.params)
    got, m_got = TS.loss_and_grads(
        cfg, on_card, {k: v.cuda() for k, v in batch.items()})
    bad = grads_against(got, want)
    log(f"  16c: falcon-mamba smoke fp32 gradients, card against CPU: loss "
        f"{float(m_got['loss']):.6f} / {float(m_want['loss']):.6f}; "
        f"{len(bad)} leaves past 1e-5 {bad[:8]}; 16c took "
        f"{time.perf_counter() - t0:.1f}s")
    check(not bad, "16c: the smoke step's gradients on the card against "
          "the CPU's")


# -- phase 17: sharded quantization, ranks sharing the card over gloo -----

PHASE17 = os.path.join(ROOT, "build", "phase17")


class ShardShapes:
    """This process's CUDA launches of ``gptq_block`` / ``rpiq_block`` by
    the shape of the block each was given (the two kernel wrappers
    wrapped; ``rpiq_block``'s rows padded to 32 there)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.counts: dict = {}
        for name in ("gptq_block_cuda", "rpiq_block_cuda"):
            setattr(ops, name, self._wrap(name[:-len("_cuda")],
                                          getattr(ops, name)))

    def _wrap(self, op: str, fn):
        def call(w, *a, **kw):
            key = f"{op} {tuple(w.shape)}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return fn(w, *a, **kw)
        return call


def sharded_rank(rank: int, world: int, job: dict) -> None:
    """One rank of phase 17a / 17c: the in-process API,
    ``quantize_model(cfg)`` with ``quant.mesh`` set, on the one card
    shared over gloo. Writes ``rank<r>.json`` (wall, launches, shard
    shapes, peak, the digests of its packed artifact and quantized
    leaves, its records) and, on rank 0 where its leaves are not bitwise
    the one-device run's (``job["want_leaves"]``), the quantized leaves
    for the parent to count the cells that differ."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{job['dir']}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600))
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.distributed.checkpoint import tree_digest
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    shapes = ShardShapes()
    cfg = job_config(job)
    cfg.quant.mesh = job["mesh"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, "cuda")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7),
                                *job["calib"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    params_q, report = quantize_model(cfg, params, calib)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() - held
    del params
    out = dict(rank=rank, wall=wall, launches=launches,
               shapes=shapes.counts, peak=peak, held=held,
               artifact=tree_digest(pack_for_serving(cfg, params_q)),
               leaves=leaf_digests(params_q), summary=report.summary(),
               records=[[x.name, x.mode] for x in report.linears],
               pipeline={k: v for k, v in report.pipeline_stats.items()
                         if k in ("steps", "spec_captures", "repairs",
                                  "moe_spec_layers")})
    if rank == 0 and out["leaves"] != job["want_leaves"]:
        torch.save(host_leaves(params_q), os.path.join(job["dir"], "q.pt"))
    del params_q
    if job.get("train"):
        dist.barrier()
        out["train"] = sharded_train_rank(job)
        out["split"] = split_train_rank()
        out["split_grads"] = split_grads_rank()
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# 17a's training leg: opt-proxy at full width, steps of batch x seq tokens,
# then sp_steps of them from the seeded init under parallel.sp (4 steps,
# 5 before the recurrentgemma and deepseek legs came: with the split
# legs' 2, the cut that pays for them)
TRAIN_LEG = dict(steps=4, batch=16, seq=128, sp_steps=2)
# the bytes a rank handed to gloo a step before the model axis computed
# its share (whole parameters gathered on every rank; opt-proxy 2x2 on
# an NVIDIA H100 80GB HBM3, 700 W)
GLOO_BYTES_WHOLE = 1136099332


def train_leg_config(ckpt_dir: str, sp: bool = False):
    """opt-proxy's, under ``parallel.remat=full`` (the launcher's
    default: a super-block's forward, its collectives and the split plan
    it reads, recomputed on autograd's own thread in the backward).
    ``sp``: ``parallel.sp`` and ``sp_steps`` steps."""
    from repro_torch.configs import get_config
    cfg = get_config("opt-proxy")
    cfg.parallel.remat = "full"
    cfg.parallel.sp = sp
    t = cfg.train
    t.steps, t.global_batch_size, t.seq_len = (
        TRAIN_LEG["sp_steps" if sp else "steps"], TRAIN_LEG["batch"],
        TRAIN_LEG["seq"])
    t.ckpt_dir = ckpt_dir
    return cfg


def state_digest(tree) -> str:
    """One sha256 over every leaf of a (train state) tree, path, dtype
    and shape included, read on the host."""
    import hashlib
    import torch
    from repro_torch.distributed.checkpoint import tree_paths
    h = hashlib.sha256()
    for k, t in tree_paths(tree):
        h.update(f"{k}{t.dtype}{tuple(t.shape)}".encode())
        a = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        h.update(memoryview(a.numpy()))
    return h.hexdigest()


def against_one_device(got, want: dict) -> tuple:
    """(the leaves of the state ``got`` past 1e-5 relative of ``want``
    ({path: tensor}), each with its distance; whether those are inside
    the JAX package's sharded pins, rtol 3e-2 / atol 3e-3)."""
    import torch
    from repro_torch.distributed.checkpoint import tree_paths
    past, within = [], True
    for k, g in tree_paths(got):
        w, g = want[k].float(), g.float()
        rel = float((g - w).norm() / (w.norm() + 1e-30))
        if rel > 1e-5:
            past.append(f"{k} {rel:.2e}")
            within &= bool(torch.allclose(g, w, rtol=3e-2, atol=3e-3))
    return past, within


def sharded_train_rank(job: dict) -> dict:
    """This rank's part of 17a's training leg: ``train(cfg, mesh=)`` on a
    2x2 mesh of the four ranks, sharing the card over gloo, from the
    seeded init, the ``model`` axis computing its share (the Megatron
    split); rank 0 writes the final checkpoint. Then ``sp_steps`` steps
    from the same init under ``parallel.sp``. Returns, for each run
    (``sp`` the second), the step walls and losses, the bytes handed to
    gloo a step and by kind (each step wrapped), the peak above what the
    rank held, the wall and the final state's digest. Rank 0 then runs
    ``train(cfg, device="cuda")`` from the same init for ``steps`` steps
    (its state kept at ``sp_steps``) and returns, under ``one``, its walls
    and losses and each run's leaves against it
    (:func:`against_one_device`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import MarkovLM
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import tree_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import trainer
    mesh = make_host_mesh(data=2, model=2, device="cuda")
    make = trainer.make_sharded_train_step
    make_one = trainer.make_train_step
    steps: list = []
    finals: list = []

    def counted(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            sharding.reset_comm_bytes()
            out = step(state, batch)
            steps.append((sharding.comm_bytes(), sharding.comm_by_kind()))
            return out
        return run

    trainer.make_sharded_train_step = counted

    def one_run(cfg) -> dict:
        steps.clear()
        release_device()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = trainer.train(cfg, MarkovLM(cfg.model.vocab_size,
                                          seed=cfg.train.seed),
                            device="cuda", mesh=mesh, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if dist.get_rank() == 0:
            finals.append(out["state"])
        return dict(wall=wall, step_walls=[h["dt"] for h in out["history"]],
                    losses=[h["loss"] for h in out["history"]],
                    step_bytes=[n for n, _ in steps],
                    step_kinds=[{k: v["bytes"] for k, v in kinds.items()}
                                for _, kinds in steps],
                    peak=torch.cuda.max_memory_allocated() - held,
                    digest=state_digest(out["state"]))

    res = one_run(train_leg_config(os.path.join(job["dir"], "train_ck")))
    res["sp"] = one_run(train_leg_config(
        os.path.join(job["dir"], "train_ck_sp"), sp=True))
    if finals:
        at_sp: dict = {}

        def keeping(cfg):
            step = make_one(cfg)

            def run(state, batch):
                state, m = step(state, batch)
                if int(state.step) == TRAIN_LEG["sp_steps"]:
                    at_sp.update((k, t.clone()) for k, t in
                                 tree_paths(state))
                return state, m
            return run

        trainer.make_train_step = keeping
        cfg = train_leg_config(os.path.join(job["dir"], "train_ck_one"))
        t = time.perf_counter()
        ref = trainer.train(cfg, MarkovLM(cfg.model.vocab_size,
                                          seed=cfg.train.seed),
                            device="cuda", verbose=False)
        torch.cuda.synchronize()
        one = dict(wall=time.perf_counter() - t,
                   step_walls=[h["dt"] for h in ref["history"]],
                   losses=[h["loss"] for h in ref["history"]])
        one["past"], one["within"] = against_one_device(
            finals[0], dict(tree_paths(ref["state"])))
        one["sp_past"], one["sp_within"] = against_one_device(finals[1],
                                                              at_sp)
        res["one"] = one
        del ref, at_sp, finals[:]
    dist.barrier()
    return res


# 17a's split legs, in the same world after the opt-proxy leg: the model
# axis computing its share of Mamba (falcon-mamba-7b, 2 of 64 layers: 2048
# of 8192 channels a rank), of routed experts (olmoe-1b-7b, 1 of 16
# layers: 16 of 64 experts a rank) and of RG-LRU (recurrentgemma-9b, one
# period of 3 of 38 layers: 1024 of 4096 channels, 4 of 16 q-heads a
# rank; 1,705,062,400 parameters) at full width on 1x4, SPLIT_RUN's steps
# of batch x seq tokens, then sp_steps of them from the seeded init under
# parallel.sp; remat full; falcon-mamba and recurrentgemma in bf16
# compute (as 16c), olmoe in fp32 (its experts' products bf16 as always;
# in bf16 compute the routing flips that the split's sum order causes
# carry the experts' moments past the routed pin within three steps).
# (arch, layers, compute dtype, whether a rank keeps its blocks of the
# one-device states in pinned host memory: recurrentgemma's two sets are
# 10.2 GB a rank, and four ranks' beside a one-device step (~50 GB with
# AdamW's fp32 temporaries of the 1.05e9-element tied embedding) do not fit
# the card; kept on the card by the rank past its turn, they ran it out
# of memory)
SPLIT_LEGS = (("falcon-mamba-7b", 2, "bfloat16", False),
              ("olmoe-1b-7b", 1, "float32", False),
              ("recurrentgemma-9b", 3, "bfloat16", True))
# 2 steps since the recurrentgemma and deepseek legs came (3 before: the
# cut pays for them; every check the same)
SPLIT_RUN = dict(steps=2, sp_steps=1, batch=4, seq=256, model=4)
# the leaves held at the routed-expert pin (1e-2 relative) against one
# device, params and moments
ROUTED_LEAF = r"mlp/w_(gate|up|down)$"


def split_leg_config(arch: str, layers: int, dtype: str, sp: bool = False):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg.model.num_layers = layers
    cfg.model.dtype = dtype
    cfg.parallel.remat = "full"
    cfg.parallel.sp = sp
    t = cfg.train
    t.steps = SPLIT_RUN["sp_steps" if sp else "steps"]
    t.global_batch_size, t.seq_len = SPLIT_RUN["batch"], SPLIT_RUN["seq"]
    return cfg


def split_train_rank(device: str = "cuda") -> dict:
    """This rank's part of 17a's split legs (``SPLIT_LEGS``). For each
    arch, every rank in turn (one whole state on the card at a time)
    builds the seeded init, keeps its 1x4 blocks of it, then steps one
    device (``make_train_step``) from that init ``steps`` steps and keeps
    its blocks of the state after ``sp_steps`` and after the last (in
    pinned host memory where the leg says so; rank 0's run is the
    one-device run; every rank's is the same
    program on the same card). Then the sharded step
    (``make_sharded_train_step``) runs ``steps`` steps on the blocks, and
    ``sp_steps`` under ``parallel.sp`` from the same init, the counters
    reset just before each run and read just after (and the scan kernels'
    launches by channel width), each step's gloo bytes by kind, the first
    step's row-parallel products' input widths (``linear.Tap``). Each
    rank holds its blocks against its blocks of the one-device states;
    the per-leaf sums (squared difference and norm, the JAX sharded pins'
    allclose) meet in one all-reduce. Returns, by arch and run, the
    walls, losses, bytes, peak, launches, widths, a digest of the
    replicated leaves and the losses (every rank's must be rank 0's), the
    one-device run's walls and losses, and each leaf's distance: 1e-5
    relative or, past it, rtol 3e-2 / atol 3e-3; the routed experts' at
    1e-2."""
    import hashlib
    import re
    import torch
    import torch.distributed as dist
    from repro_torch.data import MarkovLM
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import map_with_path, tree_paths
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.linear import Tap
    from repro_torch.training import train_step as TS
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(data=1, model=SPLIT_RUN["model"], device=device)
    release_device()        # what the legs before left cached
    widths: dict = {}

    def by_width(op):
        def make(fn):
            def call(u, *a):
                key = f"{op} d={u.shape[-1]}"
                widths[key] = widths.get(key, 0) + 1
                return fn(u, *a)
            return call
        return make

    def batches(cfg):
        data = MarkovLM(cfg.model.vocab_size, seed=cfg.train.seed)
        for _ in range(cfg.train.steps):
            b = data.batch(cfg.train.global_batch_size, cfg.train.seq_len)
            yield b[0] if isinstance(b, tuple) else b

    def blocks(state, specs, host: bool = False):
        def keep(_, t):
            if not host:
                return t.clone()
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        return map_with_path(sharding.local(state, specs, mesh), keep)

    dense_widths: dict = {}

    def row_width(name, x):
        if name.endswith((".o", ".down", ".out")):
            dense_widths.setdefault(name, set()).add(int(x.shape[-1]))

    def run(cfg, state, specs) -> tuple:
        rules = sharding.make_rules(mesh, cfg.parallel)
        step = TS.make_sharded_train_step(cfg, rules, specs)
        widths.clear()
        dense_widths.clear()
        release_device()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls, losses, nbytes, kinds = [], [], [], []
        ops.reset_kernel_launches()
        with patched(ops, "selective_scan_cuda", by_width("selective_scan")), \
                patched(ops, "selective_scan_bwd_cuda",
                        by_width("selective_scan_bwd")):
            for i, batch in enumerate(batches(cfg)):
                sharding.reset_comm_bytes()
                t = time.perf_counter()
                with contextlib.ExitStack() as tap:
                    if i == 0:
                        tap.enter_context(Tap(row_width))
                    state, m = step(state, batch)
                losses.append(float(m["loss"]))      # waits
                walls.append(time.perf_counter() - t)
                nbytes.append(sharding.comm_bytes())
                kinds.append({k: v["bytes"] for k, v in
                              sharding.comm_by_kind().items()})
        torch.cuda.synchronize()
        rep = dict(step_walls=walls, losses=losses, step_bytes=nbytes,
                   step_kinds=kinds, launches=ops.kernel_launches(),
                   widths=dict(widths),
                   dense_widths={k: sorted(v)
                                 for k, v in dense_widths.items()},
                   peak=torch.cuda.max_memory_allocated() - held)
        h = hashlib.sha256(json.dumps(losses).encode())
        for (k, t), (_, spec) in zip(tree_paths(state),
                                     tree_paths_specs(specs)):
            if all(a is None for a in spec):
                h.update(k.encode())
                h.update(memoryview(t.detach().contiguous().cpu().reshape(
                    -1).view(torch.uint8).numpy()))
        rep["digest"] = h.hexdigest()
        return rep, state

    def against(state, ref, specs) -> dict:
        """Every leaf's distance to the one-device state: this rank's
        sums over its blocks, summed over the ranks for a leaf split over
        ``model`` (rank 0's alone for a replicated one)."""
        names, sums = [], []
        for (k, g), (_, w), (_, spec) in zip(
                tree_paths(state), tree_paths(ref), tree_paths_specs(specs)):
            split = any(a is not None for a in spec)
            g, w = g.float(), w.to(g.device).float()
            mine = split or rank == 0
            names.append(k)
            sums.append([float((g - w).double().pow(2).sum()) * mine,
                         float(w.double().pow(2).sum()) * mine,
                         float(not torch.allclose(g, w, rtol=3e-2,
                                                  atol=3e-3)) * mine])
        tot = torch.tensor(sums, dtype=torch.float64)
        dist.all_reduce(tot)
        past, within, routed = [], True, []
        for k, (d2, w2, off) in zip(names, tot.tolist()):
            rel = d2 ** 0.5 / (w2 ** 0.5 + 1e-30)
            if re.search(ROUTED_LEAF, k):
                routed.append(rel)
                if rel > 1e-2:
                    past.append(f"{k} {rel:.2e} (routed pin 1e-2)")
                    within = False
            elif rel > 1e-5:
                past.append(f"{k} {rel:.2e}")
                within &= off == 0
        return dict(past=past, within=within,
                    routed_max=max(routed, default=0.0))

    out: dict = {}
    for arch, layers, dtype, host in SPLIT_LEGS:
        cfg = split_leg_config(arch, layers, dtype)
        t0 = time.perf_counter()
        res: dict = {}
        for r in range(world):
            if r == rank:
                state = TS.init_train_state(cfg, device)
                specs = sharding.train_state_pspecs(
                    state, sharding.make_rules(mesh, cfg.parallel))
                init = blocks(state, specs)
                step = TS.make_train_step(cfg)
                t = time.perf_counter()
                walls, losses = [], []
                for i, batch in enumerate(batches(cfg)):
                    t1 = time.perf_counter()
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                    walls.append(time.perf_counter() - t1)
                    if i + 1 == SPLIT_RUN["sp_steps"]:
                        at_sp = blocks(state, specs, host)
                one = blocks(state, specs, host)
                res["one"] = dict(wall=time.perf_counter() - t,
                                  step_walls=walls, losses=losses)
                del state
                release_device()
            dist.barrier()
        res["init_s"] = time.perf_counter() - t0
        first = map_with_path(init, lambda _, t: t.clone())
        res["split"], done = run(cfg, first, specs)
        res["sp"], done_sp = run(split_leg_config(arch, layers, dtype,
                                                  sp=True), init, specs)
        t = time.perf_counter()
        res["split"].update(against(done, one, specs))
        res["sp"].update(against(done_sp, at_sp, specs))
        res["compare_s"] = time.perf_counter() - t
        del first, init, done, done_sp, one, at_sp
        release_device()
        dist.barrier()
        out[arch] = res
    return out


# 17a's deepseek-v3-671b leg: at full width, its dense layer and the MTP
# head (3,123,095,552 parameters) in fp32, the loss and its gradients on
# 1x4 and under parallel.sp against one device. Its train step does not
# fit four ranks beside a one-device run on the shared card (PERF.md
# §6: a one-device step holds 50 GB, each rank's three block sets
# 9.6 GB each), and in its own bf16 params and int8 moments a free run
# parts at rounding and code ties.
SPLIT_GRADS = dict(arch="deepseek-v3-671b", layers=1, dtype="float32",
                   batch=4, seq=256)


def split_grads_rank(device: str = "cuda") -> dict:
    """This rank's part of 17a's deepseek leg (``SPLIT_GRADS``): every rank
    in turn builds the seeded init whole and runs the one-device
    ``train_step.loss_and_grads`` (remat full), keeping its 1x4 blocks of
    the parameters and the gradients; then the split's
    (``sharding.model_split`` under ``use_split``, as
    ``make_sharded_train_step`` runs it, the counters reset just before
    and read just after) on the blocks, without and with
    ``parallel.sp``. Returns the one-device loss and wall and, for each
    run, its loss, wall, gloo bytes by kind, peak, the products' widths
    (row-parallel inputs, the MTP projection's output), a digest of the
    loss and the replicated leaves' gradients (every rank's must be rank
    0's) and each gradient leaf's distance to one device's (the sums meet
    in one all-reduce): 1e-5 relative or, past it, 1e-4."""
    import copy
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import stack_layers
    from repro_torch.data import MarkovLM
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import map_with_path, tree_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.linear import Tap
    from repro_torch.training import train_step as TS
    from repro_torch.training.optimizer import tree_leaves
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh(data=1, model=SPLIT_RUN["model"], device=device)
    release_device()
    cfg = get_config(SPLIT_GRADS["arch"])
    mc = cfg.model
    mc.num_layers = SPLIT_GRADS["layers"]
    mc.dtype = mc.param_dtype = SPLIT_GRADS["dtype"]
    cfg.parallel.remat = "full"
    batch = MarkovLM(mc.vocab_size, seed=cfg.train.seed).batch(
        SPLIT_GRADS["batch"], SPLIT_GRADS["seq"])
    batch = {k: v.to(device) for k, v in (
        batch[0] if isinstance(batch, tuple) else batch).items()}
    rules = {}
    for sp in (False, True):
        par = copy.copy(cfg.parallel)
        par.sp = sp
        rules[sp] = sharding.make_rules(mesh, par)
    res: dict = {}
    t0 = time.perf_counter()
    for r in range(world):
        if r == rank:
            gen = torch.Generator(device=device)
            gen.manual_seed(cfg.train.seed)
            params = stack_layers(mc, T.init_params(mc, gen, device))
            specs = sharding.param_pspecs(params, rules[False])
            plan = sharding.model_split(mc, rules[False])
            gather_by, flags = sharding.split_specs(plan, specs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            grads, m = TS.loss_and_grads(cfg, params, batch)
            torch.cuda.synchronize()
            res["one"] = dict(wall=time.perf_counter() - t,
                              loss=float(m["loss"]))
            mine = map_with_path(sharding.local(params, specs, mesh),
                                 lambda _, x: x.clone())
            # the gradients as the split holds them: a split leaf's
            # model block, every other leaf whole
            cut = {}
            sharding._spec_paths(lambda k, sp: cut.__setitem__(k, sp),
                                 specs)
            sharding._spec_paths(lambda k, f: cut.__setitem__(
                k, cut[k] if f else None), flags)
            ref = map_with_path(grads, lambda k, x: (
                x if cut[k] is None
                else sharding.local_block(x, cut[k], mesh)).clone())
            del params, grads
            release_device()
        dist.barrier()
    res["init_s"] = time.perf_counter() - t0
    names = [k for k, _ in tree_paths(ref)]
    split = tree_leaves(flags)
    widths: dict = {}

    def width(name, x):
        if name.endswith((".o", ".down")):
            widths.setdefault(name, set()).add(int(x.shape[-1]))

    def proj_out(fn):
        def call(p, x, name="", reduce=None):
            y = fn(p, x, name, reduce)
            if name == "mtp.proj":
                widths.setdefault("mtp.proj:out", set()).add(
                    int(y.shape[-1]))
            return y
        return call

    for key, sp in (("split", False), ("sp", True)):
        plan = sharding.model_split(mc, rules[sp])
        params = sharding.gather(mine, gather_by, mesh)
        widths.clear()
        release_device()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sharding.reset_comm_bytes()
        t = time.perf_counter()
        with sharding.use_split(plan), Tap(width), \
                patched(T, "dense", proj_out):
            grads, m = TS.loss_and_grads(cfg, params, batch)
        loss = float(m["loss"])                   # waits
        wall = time.perf_counter() - t
        rep = dict(wall=wall, loss=loss, sp=plan.seq_split(
            SPLIT_GRADS["seq"]), bytes=sharding.comm_bytes(),
            kinds={k: v["bytes"] for k, v in
                   sharding.comm_by_kind().items()},
            peak=torch.cuda.max_memory_allocated() - held,
            widths={k: sorted(v) for k, v in widths.items()})
        h = hashlib.sha256(json.dumps(loss).encode())
        sums = []
        for k, g, w, f in zip(names, tree_leaves(grads), tree_leaves(ref),
                              split):
            g, w = g.float(), w.float()
            if not f:
                h.update(k.encode())
                h.update(memoryview(g.detach().contiguous().cpu().reshape(
                    -1).view(torch.uint8).numpy()))
            mine_too = f or rank == 0
            sums.append([float((g - w).double().pow(2).sum()) * mine_too,
                         float(w.double().pow(2).sum()) * mine_too])
        tot = torch.tensor(sums, dtype=torch.float64)
        dist.all_reduce(tot)
        rels = [d2 ** 0.5 / (w2 ** 0.5 + 1e-30) for d2, w2 in tot.tolist()]
        rep["digest"] = h.hexdigest()
        rep["max_rel"] = max(rels)
        rep["past"] = [f"{k} {x:.2e}" for k, x in zip(names, rels)
                       if x > 1e-5]
        rep["within"] = all(x <= 1e-4 for x in rels)
        rep["leaves"] = len(rels)
        res[key] = rep
        del params, grads
    del mine, ref
    release_device()
    dist.barrier()
    return res


def tree_paths_specs(specs):
    """``(path, spec)`` of a spec tree in ``checkpoint.tree_paths``'
    order (its PSpec leaves; a ``Quantized8`` spec is not expected)."""
    from repro_torch.distributed import sharding
    out = []

    def walk(tree, prefix):
        if isinstance(tree, sharding.PSpec):
            out.append((prefix, tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{prefix}/{k}" if prefix else str(k))
        elif hasattr(tree, "_fields"):
            for f in tree._fields:
                walk(getattr(tree, f), f"{prefix}/.{f}" if prefix
                     else f".{f}")
        else:
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
    walk(specs, "")
    return out


def job_config(job: dict):
    from repro_torch.configs import get_config
    cfg = get_config(job["arch"], smoke=job.get("smoke", False))
    if job.get("layers"):
        cfg.model.num_layers = job["layers"]
    cfg.quant.pipeline = job.get("pipeline", "serial")
    return cfg


def run_ranks(job: dict, world: int, leg: str, smi: str) -> list:
    """Spawn the ranks of one leg (a failed rank fails the run: spawn
    kills the others and raises); print each rank's wall, launches at
    its shard shapes and peak; check that every rank's packed artifact
    and quantized leaves are bitwise rank 0's."""
    import torch.multiprocessing as mp
    os.makedirs(job["dir"], exist_ok=True)
    t = time.perf_counter()
    mp.spawn(sharded_rank, args=(world, job), nprocs=world, join=True)
    wall = time.perf_counter() - t
    res = []
    for r in range(world):
        with open(os.path.join(job["dir"], f"rank{r}.json")) as f:
            res.append(json.load(f))
    log(f"  {leg}: {world} ranks on quant.mesh={job['mesh']}, wall "
        f"{wall:.3f} s (spawn to exit) [{smi}]")
    for x in res:
        log(f"  {leg} rank {x['rank']}: quantize_model {x['wall']:.3f} s, "
            f"peak above what it held {x['peak']} bytes; {x['summary']}; "
            f"launches gptq_block {x['launches']['gptq_block']} "
            f"rpiq_block {x['launches']['rpiq_block']} hessian_accum "
            f"{x['launches']['hessian_accum']}; at shard shapes "
            f"{json.dumps(x['shapes'], sort_keys=True)}")
    agree = all(x["artifact"] == res[0]["artifact"]
                and x["leaves"] == res[0]["leaves"]
                and x["records"] == res[0]["records"] for x in res)
    log(f"  {leg}: every rank's packed artifact (sha256 "
        f"{res[0]['artifact'][:16]}...) and quantized leaves bitwise rank "
        f"0's: {agree}")
    check(agree, f"{leg}: the ranks disagree")
    check(all(x["launches"]["gptq_block"] > 0 and
              x["launches"]["rpiq_block"] > 0 for x in res),
          f"{leg}: a rank launched no gptq_block / rpiq_block")
    return res


def cells_differing(got: dict, want: dict) -> tuple:
    """(cells of ``got`` off ``want`` at rtol 1e-5 / atol 1e-6, cells,
    largest difference) over two {path: tensor} sets of the same paths;
    the leaves that differ are printed with their counts."""
    import torch
    check(got.keys() == want.keys(), "the two runs' leaves differ in paths")
    mism = total = 0
    worst = 0.0
    where = []
    for k, a in want.items():
        a, b = a.float(), got[k].float()
        bad = ~torch.isclose(b, a, rtol=1e-5, atol=1e-6)
        mism += int(bad.sum())
        total += a.numel()
        if bad.any():
            worst = max(worst, float((b - a).abs().max()))
            where.append(f"{k} {int(bad.sum())} (largest "
                         f"{float((b - a).abs().max()):.3e})")
    if where:
        log(f"  leaves that differ: {'; '.join(where)}")
    return mism, total, worst


def cells_against(job: dict, res: list, want_q: dict) -> tuple:
    """``cells_differing`` of rank 0's quantized leaves against the
    one-device run's ``want_q``: none where their digests are equal (rank
    0 then wrote no leaves), else counted on the leaves it wrote."""
    import torch
    if res[0]["leaves"] == job["want_leaves"]:
        return 0, sum(v.numel() for v in want_q.values()), 0.0
    return cells_differing(torch.load(os.path.join(job["dir"], "q.pt")),
                           want_q)


def artifact_cells(got_path: str, want_path: str) -> tuple:
    """``cells_differing`` over two packed artifacts' leaves (codes, scales,
    zeros, float leaves), read through their sha256 sidecars; (0, None,
    0.0) without reading them where the sidecars' sha256 are equal."""
    import numpy as np
    import torch
    from repro_torch.distributed.checkpoint import (artifact_manifest_path,
                                                    load_artifact)
    shas = []
    for path in (got_path, want_path):
        with open(artifact_manifest_path(path)) as f:
            shas.append(json.load(f)["sha256"])
    if shas[0] == shas[1]:
        return 0, None, 0.0

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        if isinstance(tree, (list, tuple)):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, f"{prefix}/{i}"))
            return out
        if isinstance(tree, np.ndarray):
            return {prefix: torch.from_numpy(np.ascontiguousarray(tree))}
        return {}

    return cells_differing(flat(load_artifact(got_path)),
                           flat(load_artifact(want_path)))


def launcher_rank(argv: list) -> int:
    """``python3 chip_smoke.py launcher-rank <launch.quantize argv>``: the
    launcher's ``main(argv)`` in this process (one rank of a
    ``torch.distributed.run`` world, or alone), then one line with its
    wall, launches, shard shapes and peak."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import quantize
    shapes = ShardShapes()
    ops.reset_kernel_launches()
    t = time.perf_counter()
    quantize.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"[launcher rank {os.environ.get('RANK', 'alone')}] wall "
          f"{wall:.3f} s; launches {json.dumps(ops.kernel_launches())}; "
          f"shard shapes {json.dumps(shapes.counts, sort_keys=True)}; peak "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    return 0


def start_launcher_leg(cmd: list) -> tuple:
    """Start one ``launcher-rank`` command (alone, or every rank under
    ``torch.distributed.run``); :func:`finish_launcher_leg` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def finish_launcher_leg(started: tuple, label: str, launches: dict) -> str:
    """Wait for a started ``launcher-rank`` command, print its lines and
    add each rank's launches to ``launches``; a failure fails the run."""
    import re
    proc, t = started
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    p = subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                    stderr)
    wall = time.perf_counter() - t
    lines = [ln for ln in p.stdout.splitlines()
             if ln.startswith(("[quantize]", "[launcher rank", "[mesh]"))
             and "pipeline:" not in ln]
    for ln in lines:
        log(f"  {label}: {ln}")
    log(f"  {label}: exit {p.returncode}, wall {wall:.3f} s (start to exit)")
    if p.returncode != 0:
        log(p.stdout[-4000:])
        log(p.stderr[-4000:])
    check(p.returncode == 0, f"{label} failed")
    for counts in re.findall(r"^\[launcher rank .*?\] .*?; launches "
                             r"(\{.*?\});", p.stdout, re.M):
        for k, v in json.loads(counts).items():
            launches[k] += v
    return p.stdout


def sharded_train_leg(job: dict, res: list, smi: str) -> None:
    """17a's training leg, read from the ranks' results, for the split
    run and then the ``parallel.sp`` run: every rank's final state bitwise
    rank 0's; against ``train(device="cuda")`` from the same init and as
    many steps (rank 0's ``one``): the losses within 1e-2 and every leaf
    at 1e-5 relative or, past it (printed with its distance), at the JAX
    package's sharded pins (rtol 3e-2 / atol 3e-3); the split run's
    checkpoint (rank 0's) restored on one device bitwise its state.
    Prints each rank's step walls, gloo bytes a step (by kind, beside the
    bytes before the split) and peak beside the card."""
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.training.train_step import init_train_state
    t = time.perf_counter()
    one = res[0]["train"]["one"]
    log(f"  17a train: one device (rank 0, after the mesh runs) "
        f"{one['wall']:.3f} s; step walls "
        f"{[round(w, 4) for w in one['step_walls']]} s [{smi}]")
    for sp in (False, True):
        label = "17a train sp" if sp else "17a train"
        legs = [x["train"]["sp"] if sp else x["train"] for x in res]
        for r, x in enumerate(legs):
            log(f"  {label} rank {r}: train(mesh=2x2{', sp' if sp else ''}) "
                f"{x['wall']:.3f} s; step walls "
                f"{[round(w, 4) for w in x['step_walls']]} s; gloo bytes a "
                f"step {x['step_bytes']} (before the split "
                f"{GLOO_BYTES_WHOLE}), by kind {x['step_kinds'][-1]}; peak "
                f"above what it held {x['peak']} bytes [{smi}]")
        same = all(x["digest"] == legs[0]["digest"] for x in legs)
        past = one["sp_past" if sp else "past"]
        within = one["sp_within" if sp else "within"]
        want = one["losses"][:len(legs[0]["losses"])]
        gaps = [abs(a - b) for a, b in zip(legs[0]["losses"], want)]
        log(f"  {label}: losses 2x2 {[round(v, 5) for v in legs[0]['losses']]}"
            f" one device {[round(v, 5) for v in want]} (largest gap "
            f"{max(gaps):.3e}, tol 1e-2)")
        restored_same = True
        if not sp:
            cfg = train_leg_config(os.path.join(job["dir"], "train_ck"))
            restored, extra = Checkpointer(cfg.train.ckpt_dir).restore(
                init_train_state(cfg, "cuda"))
            restored_same = (state_digest(restored) == legs[0]["digest"]
                             and extra["step"] == cfg.train.steps)
            del restored
            release_device()
        restore = ("" if sp else "; rank 0's checkpoint restored on one "
                   f"device bitwise it {restored_same}")
        log(f"  {label}: every rank's state bitwise rank 0's {same}"
            f"{restore}; {len(past)} leaves past 1e-5 of the one-device "
            f"run (held at rtol 3e-2 / atol 3e-3: {within}): "
            f"{'; '.join(past)}")
        check(same and restored_same and within and len(gaps) == len(
            legs[0]["losses"]) and max(gaps) < 1e-2,
            f"{label} against the one-device run")
    log(f"  17a train: the restore and the checks here took "
        f"{time.perf_counter() - t:.1f}s")


def split_train_leg(res: list, smi: str, launches: dict) -> None:
    """17a's split legs, read from the ranks' results (``split_train_rank``):
    for each arch and run each rank's step walls, losses, gloo bytes a
    step by kind, peak, the scan kernels' launches by channel width and
    the row-parallel products' input widths; every rank's losses and
    replicated leaves bitwise rank 0's; against one device (rank 0's) the
    losses within 1e-2 and every leaf at its pin (printed past 1e-5); on
    falcon-mamba-7b ``selective_scan`` twice and ``selective_scan_bwd``
    once a layer a step at d 2048 on every rank; on recurrentgemma-9b
    RG-LRU's out at 1024 channels, the local layer's o at 4 q-heads and
    the MLP's down at d_ff / 4 on every rank. Adds the runs' launches to
    ``launches``."""
    d_rank = 8192 // SPLIT_RUN["model"]
    for arch, layers, _, _ in SPLIT_LEGS:
        one = res[0]["split"][arch]["one"]
        same_one = all(x["split"][arch]["one"]["losses"] == one["losses"]
                       for x in res)
        log(f"  17a {arch}: each rank's init and one-device run in turn "
            f"{res[0]['split'][arch]['init_s']:.1f} s; one device (rank 0) "
            f"{one['wall']:.3f} s, step walls "
            f"{[round(w, 4) for w in one['step_walls']]} s, every rank's "
            f"one-device losses rank 0's {same_one} [{smi}]")
        for key in ("split", "sp"):
            legs = [x["split"][arch][key] for x in res]
            label = f"17a {arch} 1x{SPLIT_RUN['model']}" + (
                ", sp" if key == "sp" else "")
            for r, x in enumerate(legs):
                log(f"  {label} rank {r}: step walls "
                    f"{[round(w, 4) for w in x['step_walls']]} s; gloo bytes"
                    f" a step {x['step_bytes']}, by kind {x['step_kinds'][-1]}"
                    f"; peak above what it held {x['peak']} bytes; scan "
                    f"launches by width {json.dumps(x['widths'], sort_keys=True)}"
                    f"; row-parallel input widths "
                    f"{json.dumps(x['dense_widths'], sort_keys=True)} [{smi}]")
                for k in launches:
                    launches[k] += x["launches"].get(k, 0)
            same = all(x["digest"] == legs[0]["digest"] for x in legs)
            want = one["losses"][:len(legs[0]["losses"])]
            gaps = [abs(a - b) for a, b in zip(legs[0]["losses"], want)]
            x0 = legs[0]
            log(f"  {label}: losses {[round(v, 5) for v in x0['losses']]} one "
                f"device {[round(v, 5) for v in want]} (largest gap "
                f"{max(gaps):.3e}, tol 1e-2); every rank's losses and "
                f"replicated leaves bitwise rank 0's {same}; {len(x0['past'])}"
                f" leaves past 1e-5 of the one-device run (held at rtol 3e-2 "
                f"/ atol 3e-3, the routed experts' at 1e-2, largest "
                f"{x0['routed_max']:.3e}: {x0['within']}): "
                f"{'; '.join(x0['past'])}")
            steps = len(x0["losses"])
            scans = True
            if arch == "falcon-mamba-7b":
                scans = all(x["widths"] == {
                    f"selective_scan d={d_rank}": 2 * layers * steps,
                    f"selective_scan_bwd d={d_rank}": layers * steps}
                    for x in legs)
                log(f"  {label}: selective_scan {2 * layers * steps} and "
                    f"selective_scan_bwd {layers * steps} launches at d "
                    f"{d_rank} on every rank: {scans}")
            if arch == "recurrentgemma-9b":
                # RG-LRU's out at lru_width / m, the local layer's o at
                # its rank's q-heads, the MLP's down at d_ff / m
                mc = split_leg_config(arch, layers, "bfloat16").model
                m = SPLIT_RUN["model"]
                want_w = {"mixer.out": [mc.rglru.lru_width // m],
                          "mixer.o": [mc.num_heads // m * mc.head_dim],
                          "mlp.down": [mc.d_ff // m]}
                scans = all(x["dense_widths"] == want_w for x in legs)
                log(f"  {label}: the row-parallel products at "
                    f"{json.dumps(want_w, sort_keys=True)} on every rank: "
                    f"{scans}")
            check(same and x0["within"] and scans and max(gaps) < 1e-2,
                  f"{label} against the one-device run")
        log(f"  17a {arch}: the comparisons took "
            f"{res[0]['split'][arch]['compare_s']:.1f}s")


def split_grads_leg(res: list, smi: str) -> None:
    """17a's deepseek leg, read from the ranks' results
    (``split_grads_rank``): for each run every rank's loss and
    replicated gradients bitwise rank 0's, the loss within 1e-5 relative
    of one device's (every rank's one-device loss rank 0's), every
    gradient leaf at 1e-5 or, past it (printed), 1e-4; the row-parallel
    products at their local widths (MLA's o at 32 of 128 heads, the
    dense MLP's down at d_ff / 4, the MTP layer's too) and the MTP
    projection's output at d_model / 4. Prints each rank's wall, gloo
    bytes by kind and peak."""
    from repro_torch.configs import get_config
    mc = get_config(SPLIT_GRADS["arch"]).model
    m = SPLIT_RUN["model"]
    arch = SPLIT_GRADS["arch"]
    one = res[0]["split_grads"]["one"]
    same_one = all(x["split_grads"]["one"]["loss"] == one["loss"]
                   for x in res)
    log(f"  17a {arch} (dense layer + MTP head, fp32, loss and gradients):"
        f" each rank's init and one-device pass in turn "
        f"{res[0]['split_grads']['init_s']:.1f} s; one device (rank 0) "
        f"{one['wall']:.3f} s, loss {one['loss']:.6f}; every rank's "
        f"one-device loss rank 0's {same_one} [{smi}]")
    want_w = {"mixer.o": [mc.num_heads // m * mc.mla.v_head_dim],
              "mlp.down": [mc.d_ff // m], "mtp.mixer.o":
              [mc.num_heads // m * mc.mla.v_head_dim],
              "mtp.mlp.down": [mc.d_ff // m],
              "mtp.proj:out": [mc.d_model // m]}
    for key in ("split", "sp"):
        legs = [x["split_grads"][key] for x in res]
        label = f"17a {arch} 1x{m}" + (", sp" if key == "sp" else "")
        for r, x in enumerate(legs):
            log(f"  {label} rank {r}: loss and gradients {x['wall']:.3f} s"
                f"; gloo bytes {x['bytes']}, by kind {x['kinds']}; peak "
                f"above what it held {x['peak']} bytes; widths "
                f"{json.dumps(x['widths'], sort_keys=True)} [{smi}]")
        x0 = legs[0]
        same = all(x["digest"] == x0["digest"] for x in legs)
        gap = abs(x0["loss"] - one["loss"]) / abs(one["loss"])
        widths_ok = all(x["widths"] == want_w for x in legs)
        log(f"  {label}: sequence sharded {x0['sp']}; loss {x0['loss']:.6f}"
            f" one device {one['loss']:.6f} (relative {gap:.3e}, tol "
            f"1e-5); every rank's loss and replicated gradients bitwise "
            f"rank 0's {same}; {x0['leaves']} gradient leaves, largest "
            f"{x0['max_rel']:.3e}, {len(x0['past'])} past 1e-5 (held at "
            f"1e-4: {x0['within']}): {'; '.join(x0['past'])}; widths "
            f"as the plan's {widths_ok}")
        check(same and same_one and gap <= 1e-5 and x0["within"]
              and widths_ok and x0["sp"] == (key == "sp"),
              f"{label} against one device")


SHARDED_LAYERS = 4      # of internlm2-1.8b's 24 in 17b (8 before 17a's
#                         recurrentgemma and deepseek legs)


def phase_sharded_path(smi: str) -> dict:
    """17a opt-proxy at full width on 2x2 (4 ranks, the in-process API)
    against phase 5's single-device run, then trained on 2x2 by the same
    ranks against one device (``sharded_train_leg``), then falcon-mamba-7b,
    olmoe-1b-7b and recurrentgemma-9b trained on 1x4 by them
    (``split_train_leg``) and deepseek-v3-671b's loss and gradients
    (``split_grads_leg``); 17b
    internlm2-1.8b
    at full width, ``SHARDED_LAYERS`` of its layers, on 1x2 (every group
    row-sharded) through
    ``torch.distributed.run`` against the launcher run without the mesh;
    17c olmoe-1b-7b at full width on 1x1x2 under overlap (cut to one
    layer; the smoke config if two ranks' peaks would not fit) against the
    same run on one device. The ranks
    share the card over gloo; every rank runs the hand-written
    ``gptq_block`` / ``rpiq_block`` on its shard."""
    import shutil
    import torch
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T

    shutil.rmtree(PHASE17, ignore_errors=True)
    launches = {k: 0 for k in KERNEL_SOURCES}

    def add(res):
        for x in res:
            for k in launches:
                launches[k] += x["launches"][k]

    # 17a
    t = time.perf_counter()
    job = dict(dir=os.path.join(PHASE17, "a"), arch="opt-proxy",
               mesh="2x2", calib=(4, 4, 128), want_leaves=MAIN_RUN["leaves"],
               train=True)
    res = run_ranks(job, 4, "17a", smi)
    add(res)
    mism, total, worst = cells_against(job, res, MAIN_RUN["q"])
    modes = [tuple(x) for x in res[0]["records"]] == MAIN_RUN["records"]
    log(f"  17a against phase 5's single-device run: {mism} of {total} "
        f"cells differ at rtol 1e-5 / atol 1e-6 (tol 1e-3 of them; largest "
        f"{worst:.3e}); every linear's name and mode equal {modes}")
    check(mism <= 1e-3 * total and modes, "17a against phase 5")
    sharded_train_leg(job, res, smi)
    split_train_leg(res, smi, launches)
    split_grads_leg(res, smi)
    log(f"  17a took {time.perf_counter() - t:.1f}s")

    # 17b
    t = time.perf_counter()
    b = os.path.join(PHASE17, "b")
    argv = ["--arch", "internlm2-1.8b"]
    over = [f"train.ckpt_dir={os.path.join(b, 'none')}",
            "quant.calib_batches=4", "quant.calib_batch_size=4",
            "quant.calib_seq_len=128", f"model.num_layers={SHARDED_LAYERS}"]
    me = os.path.abspath(__file__)
    # the one-device launcher and the mesh's ranks run side by side (their
    # walls each under the other's load)
    one = start_launcher_leg([sys.executable, me, "launcher-rank", *argv,
                              "--out", os.path.join(b, "one"), *over])
    mesh = start_launcher_leg(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", me, "launcher-rank", *argv, "--out",
         os.path.join(b, "mesh"), *over, "quant.mesh=1x2"])
    try:
        finish_launcher_leg(one, "17b one device", launches)
    finally:
        out = finish_launcher_leg(mesh, "17b mesh 1x2", launches)
    art = "internlm2-1.8b.params.pkl"
    mism, total, worst = artifact_cells(os.path.join(b, "mesh", art),
                                        os.path.join(b, "one", art))
    reps = []
    for leg in ("one", "mesh"):
        with open(os.path.join(b, leg, "internlm2-1.8b.report.json")) as f:
            reps.append([(x["name"], x["mode"]) for x in json.load(f)])
    agree = "2 ranks' packed artifacts bitwise equal" in out
    placed = "sharded group execution on mesh {'data': 1, 'model': 2}" in out
    cells = ("bitwise (sha256 equal)" if total is None else
             f"{mism} of {total} cells differ (tol 1e-3 of them; largest "
             f"{worst:.3e})")
    log(f"  17b: the mesh's artifact against the one-device launcher's: "
        f"{cells}; names and modes equal {reps[0] == reps[1]}; the ranks' "
        f"artifacts bitwise equal {agree}; placed {placed}")
    check((total is None or mism <= 1e-3 * total) and reps[0] == reps[1]
          and agree and placed, "17b against the one-device launcher")
    log(f"  17b took {time.perf_counter() - t:.1f}s")

    # 17c: one rank's peak first (the one-device run), then the ranks
    t = time.perf_counter()
    job = dict(dir=os.path.join(PHASE17, "c"), arch="olmoe-1b-7b",
               layers=1, mesh="1x1x2", pipeline="overlap",
               calib=(4, 4, 512))
    ref = None
    for attempt in ("full width", "smoke"):
        cfg = job_config(job)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = T.init_params(cfg.model, gen, "cuda")
        calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7),
                                    *job["calib"])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        pbytes = sum(v.numel() * v.element_size()
                     for v in host_leaves(params).values())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q_ref, rep_ref = quantize_model(cfg, params, calib, mesh=None)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        ref = dict(q=host_leaves(q_ref),
                   records=[(x.name, x.mode) for x in rep_ref.linears])
        job["want_leaves"] = leaf_digests(q_ref)
        del params, q_ref, rep_ref
        release_device()
        card = torch.cuda.get_device_properties(0).total_memory
        need = 2 * (peak + pbytes + (2 << 30))
        log(f"  17c one device ({attempt}, {cfg.model.num_layers} layers): "
            f"quantize_model {one_s:.3f} s, peak above the float params "
            f"{peak} bytes, params {pbytes} bytes; two ranks would need "
            f"~{need} of {card} bytes")
        if need <= 0.9 * card or attempt == "smoke":
            break
        log("  17c: two ranks' peaks do not fit the card: the smoke config")
        job.update(smoke=True, layers=0, calib=(3, 4, 32))
    res = run_ranks(job, 2, "17c", smi)
    add(res)
    mism, total, worst = cells_against(job, res, ref["q"])
    modes = [tuple(x) for x in res[0]["records"]] == ref["records"]
    pipe = res[0]["pipeline"]
    expert = all(any(k.startswith(("gptq_block (32,", "rpiq_block (32,"))
                     for k in x["shapes"]) for x in res) \
        if not job.get("smoke") else True
    log(f"  17c against the one-device run: {mism} of {total} cells differ "
        f"(tol 1e-3 of them; largest {worst:.3e}; lanes only: bitwise "
        f"{mism == 0}); names and modes equal {modes}; the walk "
        f"{json.dumps(pipe)}; expert lanes 64 -> 32 a rank {expert}")
    check(mism <= 1e-3 * total and modes and pipe["steps"] == 1
          and expert, "17c against the one-device run")
    log(f"  17c took {time.perf_counter() - t:.1f}s")
    shutil.rmtree(PHASE17, ignore_errors=True)
    return launches


# -- 18: the fault plane's process-level checks and the dry run ------------

# the dry run's live-bytes high-water over the measured peak: the bound
# PERF.md states for 18c (each side counts the arguments the traced step
# runs on)
DRYRUN_PEAK_RATIO = (0.85, 1.15)
# peaks this script measured at a cut depth of a full-width quantization
# walk (PERF.md §5; runs CC and BL): (arch, layers) -> bytes
DRYRUN_MEASURED = {("recurrentgemma-9b", 33): 69580873728,
                   ("pixtral-12b", 26): 73196823552}
# the walks the dry run reckons: arch, depths, calibration (phases 13, 9b)
DRYRUN_WALKS = (("recurrentgemma-9b", (33, 38), "4x4x512"),
                ("pixtral-12b", (26, 40), "4x2x128"))


def start_phase18_processes(out: str) -> dict:
    """Phase 18's own processes, started together before phase 13 and read
    in phase 18: ``"smoke"``, 18a (``scripts/torch_resume_smoke.py
    --int8-only``, whose launcher children wait on their own start-up most
    of the time), and ``"reckonings"``, the dry run's reckonings of 18c
    (2) and (3), one host process each (``launch.dryrun`` writing into
    ``out``; the card hidden: they need none, and their fake tensors claim
    the CPU)."""
    src = os.path.join(ROOT, "src")
    smoke = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_resume_smoke.py"),
         "--int8-only"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=src))
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
    jobs = [cmd + ["--quant-cell", "--arch", "deepseek-v3-671b",
                   "--quant-mesh", "1x2x256"],
            cmd + ["--arch", "internlm2-1.8b", "--shape", "train_4k",
                   "--mesh", "pod"]]
    for arch, depths, calib in DRYRUN_WALKS:
        jobs += [cmd + ["--quant-walk", "--arch", arch, "--layers", str(n),
                        "--calib", calib] for n in depths]
    return {"smoke": smoke,
            "reckonings": [(j, subprocess.Popen(
                j, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)) for j in jobs]}


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree of tensors."""
    import torch
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen[x.untyped_storage().data_ptr()] = \
                x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__"):
            for v in vars(x).values():
                walk(v)
    walk(tree)
    return sum(seen.values())


def measured_step(step, args) -> tuple:
    """``step()`` eager on the card: ``(kernel launches, peak bytes)``, the
    peak the arguments' bytes plus what the step allocated above what was
    held before it."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    release_device()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    out = step()
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() - held + storage_bytes(args)
    del out
    return launches, peak


def dryrun_against_step(label: str, cfg, shape, real_args, real_step,
                        smi: str) -> dict:
    """18c (1): one cell traced on fake CUDA tensors on a mesh of one
    against the same step run eagerly on the card."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    launches, peak = measured_step(real_step, real_args)
    before = ops.kernel_launches()
    t = time.perf_counter()
    with fake_world(1):
        rules = shd.make_rules(dryrun._groups_ready(make_host_mesh()),
                               cfg.parallel)
        cc, _ = dryrun.trace_cell(cfg, shape, rules)
    wall = time.perf_counter() - t
    fake = {k: cc.kernels[k] for k in launches}
    mem = cc.memory_analysis()
    ratio = mem["peak_memory_in_bytes"] / peak
    log(f"  18c {label}: eager step launches {json.dumps(launches)}; the "
        f"fake pass called {json.dumps(fake)} (traced in {wall:.2f}s on "
        f"fake {cost.fake_device()} tensors); peak: traced {mem['peak_memory_in_bytes']} "
        f"bytes (arguments {mem['argument_size_in_bytes']}, temporaries "
        f"{mem['temp_size_in_bytes']}) against measured {peak} "
        f"(max_memory_allocated above what was held, plus the arguments): "
        f"ratio {ratio:.4f} (bound {DRYRUN_PEAK_RATIO}) [{smi}]")
    check(fake == launches, f"18c {label}: the fake pass calls each kernel "
          "as often as the eager step launches it")
    check(ops.kernel_launches() == before and not dist.is_initialized(),
          f"18c {label}: the dry run launched nothing and left no group")
    check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
          f"18c {label}: traced peak against measured")
    return launches


def phase_fault_and_dryrun(smi: str, out: str, procs: dict) -> dict:
    """18 (module docstring): ``procs`` 18a's process and the dry run's
    reckonings (writing into ``out``), started before phase 13
    (``start_phase18_processes``). Returns the kernel launches of 18a's
    children, 18b's soak and 18c's eager steps."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import stand_in_dtypes
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import serve_step
    from repro_torch.training import train_step as TS
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_chaos_soak

    launches = {k: 0 for k in KERNEL_SOURCES}
    t0 = time.perf_counter()

    # -- 18b: the chaos soak, seed 0, on the card
    release_device()
    t = time.perf_counter()
    ops.reset_kernel_launches()
    rc = torch_chaos_soak.main(["--seeds", "0", "--smoke", "--device",
                                "cuda"])
    soak = ops.kernel_launches()
    log(f"  18b: {time.perf_counter() - t:.1f}s, launches "
        f"{json.dumps(soak)}")
    check(rc == 0, "18b: torch_chaos_soak found violations")
    for name in ("hessian_accum", "gptq_block", "rpiq_block", "quant_pack"):
        check(soak[name] > 0, f"18b: kernel {name} was not launched")
    for k, v in soak.items():
        launches[k] += v

    # -- 18c (1): two cells this script runs, traced and measured
    release_device()
    cfg = get_config("opt-proxy")
    mc = cfg.model
    b, max_len = 4, 16 + 16 + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the dry run's stand-in dtypes (launch/specs.py), packed
    with torch.no_grad():
        packed = pack_for_serving(cfg, stand_in_dtypes(
            mc, T.init_params(mc, gen, "cuda")))
    caches = T.init_caches(mc, b, max_len, "cuda", torch.bfloat16)
    tok = torch.ones((b,), dtype=torch.long, device="cuda")
    pos = torch.full((b,), 16, dtype=torch.long, device="cuda")

    def decode():
        with torch.no_grad():
            return serve_step(cfg, packed, tok, pos, caches)
    for k, v in dryrun_against_step(
            "opt-proxy decode step (packed, 4 lanes, bf16 cache)", cfg,
            ShapeSpec("phase5", "decode", max_len, b),
            (packed, caches, tok, pos), decode, smi).items():
        launches[k] += v
    del packed, caches, decode

    release_device()
    cfg = get_config("internlm2-1.8b")
    cfg.parallel.remat = "full"
    cfg.train.lr, cfg.train.warmup_steps = 3e-4, 1
    state = TS.init_train_state(cfg, torch.device("cuda"))
    batch = MarkovLM(cfg.model.vocab_size, seed=0, branching=3).batch(4, 512)
    batch = {k: v.cuda() for k, v in batch.items()}
    step = TS.make_train_step(cfg)
    dryrun_against_step("internlm2-1.8b train step (4 x 512, remat full, "
                        "fp32 moments)", cfg,
                        ShapeSpec("phase16b", "train", 512, 4),
                        (state, batch), lambda: step(state, batch), smi)
    del state, batch, step
    release_device()

    # -- 18a: kill and resume over process boundaries, int8 KV
    smoke = procs["smoke"]
    text, _ = smoke.communicate()
    child = {}
    for line in text.splitlines():
        log(f"  {line}")
        if "the children's kernel launches: " in line:
            child = json.loads(line.split("launches: ", 1)[1])
    log(f"  18a read {time.perf_counter() - t0:.1f}s into phase 18, the "
        f"children's launches {json.dumps(child)} [{smi}]")
    check(smoke.returncode == 0, "18a: torch_resume_smoke")
    for name in ("hessian_accum", "gptq_block", "rpiq_block", "quant_pack",
                 "w4a16_matmul", "int8_kv_attention"):
        check(child.get(name, 0) > 0, f"18a: kernel {name} was not "
              "launched by the launchers")
        launches[name] += child[name]

    # -- 18c (2) and (3): the reckonings started before phase 13
    for cmd, p in procs["reckonings"]:
        text, _ = p.communicate()
        for line in text.splitlines():
            if line.startswith("[dryrun]"):
                log(f"  {line}")
        check(p.returncode == 0, f"18c: {' '.join(cmd[2:])} failed:\n"
              + text[-4000:])
    log(f"  18c reckonings read {time.perf_counter() - t0:.1f}s into "
        "phase 18")
    card = torch.cuda.get_device_properties(0).total_memory
    qc = json.load(open(os.path.join(
        out, "deepseek-v3-671b__quant__1x2x256.json")))
    tr = json.load(open(os.path.join(
        out, "internlm2-1.8b__train_4k__16x16.json")))
    for leg in ("capture", "stage1", "stage2", "serve"):
        log(f"  18c deepseek-v3-671b quant cell on 1x2x256, {leg}: rank peak "
            f"{qc[leg + '_memory_analysis']['peak_memory_in_bytes']} bytes, "
            f"kernels {json.dumps(qc[leg + '_kernel_calls'])}, collectives "
            f"{json.dumps(qc[leg + '_collectives']['counts'])}")
    log(f"  18c internlm2-1.8b train_4k on 16x16: rank peak "
        f"{tr['memory_analysis']['peak_memory_in_bytes']} bytes, "
        f"{tr['per_device_flops']:.4e} FLOP, {tr['per_device_bytes']:.4e} "
        f"bytes, collectives {json.dumps(tr['collectives']['counts'])}, "
        f"dominant {tr['dominant']}")
    check(qc["stage1_kernel_calls"]["gptq_block"] == 1
          and qc["stage2_kernel_calls"]["rpiq_block"] == 1
          and qc["serve_kernel_calls"]["w4a16_matmul"] > 0,
          "18c: the quant cell's stages reach their kernels")
    answer = []
    for arch, depths, _ in DRYRUN_WALKS:
        for n in depths:
            art = json.load(open(os.path.join(
                out, f"{arch}__quantwalk__{n}.json")))
            peak = art["memory_analysis"]["peak_memory_in_bytes"]
            want = DRYRUN_MEASURED.get((arch, n))
            fits = peak <= card
            vs = ""
            if want is not None:
                ratio = peak / want
                vs = (f" against measured {want}: ratio {ratio:.4f} "
                      f"(bound {DRYRUN_PEAK_RATIO})")
                check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
                      f"18c: {arch} at {n} layers, traced peak against "
                      "measured")
            log(f"  18c {arch} quantization walk at {n} of "
                f"{art['full_layers']} layers: traced peak {peak} bytes"
                f"{vs}; the card holds {card}: "
                f"{'fits' if fits else 'does not fit'}")
            if n == art["full_layers"]:
                answer.append(f"{arch} at all {n} layers "
                              f"{'fits' if fits else 'does not fit'} "
                              f"({peak} bytes)")
    serve_fits = qc["serve_memory_analysis"]["peak_memory_in_bytes"] <= card
    capture_fits = qc["capture_memory_analysis"]["peak_memory_in_bytes"] \
        <= card
    answer.append(f"deepseek-v3-671b's routed layer capture "
                  f"{'fits' if capture_fits else 'does not fit'} one card "
                  f"({qc['capture_memory_analysis']['peak_memory_in_bytes']}"
                  f" bytes), its quantized serve step on 2x16x16 "
                  f"{'fits' if serve_fits else 'does not fit'} a rank")
    log(f"  queue 2 item 7 (quantization memory): {'; '.join(answer)}")
    shutil.rmtree(out, ignore_errors=True)
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
    t = time.perf_counter()
    table = KernelTable()
    phase_kernels(table)
    from repro_torch.kernels import ops
    log(f"  launches in this phase (checks and timing): "
        f"{json.dumps(ops.kernel_launches())}")
    log(f"  phase 3 took {time.perf_counter() - t:.1f}s")

    log("[4] small end to end: smoke configs, card against CPU plain (fp32),"
        " then at their own bf16 and group size on the card; then the "
        "chunked prefill, a continuous run and the guardrail ladder")
    t = time.perf_counter()
    phase_small_end_to_end("opt-proxy", "fp16")
    phase_small_end_to_end("internlm2-1.8b", "int8")
    phase_small_end_to_end("falcon-mamba-7b", "fp16")
    phase_small_bf16("opt-proxy", "fp16")
    phase_small_bf16("internlm2-1.8b", "int8")
    phase_small_bf16("falcon-mamba-7b", "fp16")
    for arch, kv_cache in SMALL_DENSE:
        phase_small_end_to_end(arch, kv_cache)
        phase_small_bf16(arch, kv_cache)
    phase_small_starved()
    for arch, kv_cache in SMALL_SERVING:
        phase_small_serving(arch, kv_cache)
    for arch in NAIVE_LEGS:
        phase_small_naive(arch)
    log(f"  phase 4 took {time.perf_counter() - t:.1f}s")

    phases = [
        ("5", "main path at full width: opt-proxy", phase_main_path),
        ("6", "main path at full width: internlm2-1.8b, int8 KV cache",
         phase_int8_kv_path),
        ("7", f"main path at full width: falcon-mamba-7b (Mamba-1, "
         f"{MAMBA_LAYERS} of 64 layers)", phase_mamba_path),
        ("8", "the entry points at full width: launch.quantize, "
         "launch.serve, the example twins",
         lambda: phase_entry_points(table, smi)),
        ("9a", f"the ring path at full width: h2o-danube-1.8b ("
         f"{RING_LAYERS} of 24 layers, sliding window 4096, head_dim 80)",
         lambda: phase_ring_path(smi)),
        ("9b", f"the vision-language path at full width: pixtral-12b ("
         f"{VLM_LAYERS} of 40 layers) with 1024 patch embeddings",
         lambda: phase_vlm_path(smi)),
        ("10", f"the encoder-decoder path at full width: whisper-large-v3 "
         f"({ENCDEC_LAYERS} + {ENCDEC_LAYERS} of 32 + 32 layers, 1500 "
         "frames)",
         lambda: phase_encdec_path(smi)),
        ("11", "the routed-MoE path at full width and depth: olmoe-1b-7b "
         "(64 experts, top 8)", lambda: phase_moe_path(smi)),
    ]
    launches = {k: 0 for k in KERNEL_SOURCES}
    for n, what, run in phases:
        if n not in ("5", "6", "7", "8"):
            release_device()
        log(f"[{n}] {what}")
        t = time.perf_counter()
        for name, n_launched in run().items():
            launches[name] += n_launched
        log(f"  phase {n} took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[12] the continuous path at full width and depth: internlm2-1.8b "
        "behind ContinuousEngine (8 lanes, chunked prefill, int8 cache)")
    t = time.perf_counter()
    for name, n in phase_continuous_path(smi).items():
        launches[name] += n
    log(f"  phase 12 took {time.perf_counter() - t:.1f}s")

    # phase 18's own processes (18a's launchers, the dry run's host-only
    # reckonings), started here to run beside phases 13 and 14, which keep
    # the card busy and leave the host's cores free
    dryrun_out = os.path.join(ROOT, "build", "phase18")
    shutil.rmtree(dryrun_out, ignore_errors=True)
    background = start_phase18_processes(dryrun_out)
    log(f"  phase 18's processes started: 18a and "
        f"{len(background['reckonings'])} dry-run reckonings")

    release_device()
    log(f"[13] the RG-LRU hybrid at full width: recurrentgemma-9b "
        f"({HYBRID_LAYERS} of 38 layers; bf16 and int8 rings, the wrap "
        "inside the replay)")
    t = time.perf_counter()
    for name, n in phase_hybrid_path(smi).items():
        launches[name] += n
    log(f"  phase 13 took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[14] multi-head latent attention at full width: deepseek-v3-671b "
        "(its 3 dense layers and the MTP head)")
    t = time.perf_counter()
    for name, n in phase_mla_path(smi).items():
        launches[name] += n
    log(f"  phase 14 took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[15] the overlap schedule at full width and depth: olmoe-1b-7b and "
        "internlm2-1.8b, the next layer's capture ahead on a side stream")
    log(f"  bytes held on the card before phase 15: "
        f"{torch.cuda.memory_allocated()}")
    t = time.perf_counter()
    for name, n in phase_overlap_path(smi).items():
        launches[name] += n
    log(f"  phase 15 took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[16] training on the card: opt-proxy through launch.train (a "
        "SIGTERM'd run resumed bitwise), quantized and served; "
        "internlm2-1.8b at full width and depth; falcon-mamba-7b (2 of 64 "
        "layers) through the scan's backward kernel")
    log(f"  bytes held on the card before phase 16: "
        f"{torch.cuda.memory_allocated()}")
    t = time.perf_counter()
    for name, n in phase_training_path(smi).items():
        launches[name] += n
    log(f"  phase 16 took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[17] sharded quantization and training on the card: ranks sharing "
        "it over gloo (17a opt-proxy 2x2, quantized then trained, then "
        "falcon-mamba-7b, olmoe-1b-7b and recurrentgemma-9b trained on "
        "1x4, deepseek-v3-671b's loss and gradients on 1x4; 17b "
        "internlm2-1.8b 1x2 through torch.distributed.run, 17c olmoe-1b-7b "
        "1x1x2 under overlap)")
    t = time.perf_counter()
    for name, n in phase_sharded_path(smi).items():
        launches[name] += n
    log(f"  phase 17 took {time.perf_counter() - t:.1f}s")

    release_device()
    log("[18] the fault plane's process-level checks (18a kill and resume "
        "over process boundaries, 18b the chaos soak) and the shape-only "
        "dry run held against this run (18c)")
    t = time.perf_counter()
    for name, n in phase_fault_and_dryrun(smi, dryrun_out,
                                          background).items():
        launches[name] += n
    log(f"  phase 18 took {time.perf_counter() - t:.1f}s")

    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(table.json(launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


def quantize_depth(arch: str = "recurrentgemma-9b",
                   calib_shape=(4, 4, 512)) -> int:
    """``python3 chip_smoke.py quantize-depth`` (not a phase: ~95 s of
    quantization): ``quantize_model`` of ``arch`` at full width and all
    its layers on phase 13's calibration, its wall and its peak above what
    was held before its params were made, beside the same walk traced on
    fake tensors (``launch/dryrun.quant_walk``): whether the dry run's
    "fits" (18c) holds on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    build.build_all()
    cfg = get_config(arch)
    mc = cfg.model
    cc, traced_s = dryrun.quant_walk(arch, mc.num_layers, calib_shape)
    traced = cc.memory_analysis()["peak_memory_in_bytes"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(mc, gen, "cuda")
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7),
                                *calib_shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, report = quantize_model(cfg, params, calib)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    card = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"quantize {arch} at all {mc.num_layers} layers, calibration "
        f"{'x'.join(map(str, calib_shape))}: quantize_model {wall:.3f} s "
        f"({report.summary()}); peak above what was held {peak} bytes, "
        f"the dry run traced {traced} bytes in {traced_s:.1f} s (traced / "
        f"measured {traced / peak:.4f}); the card holds {card} bytes "
        f"[{smi}]")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["launcher-rank"]:
        sys.exit(launcher_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["quantize-depth"]:
        sys.exit(quantize_depth())
    sys.exit(main())
