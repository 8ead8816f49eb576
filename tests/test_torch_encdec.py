"""The encoder-decoder path (whisper-large-v3 smoke: 2 + 2 layers, d 64)
against the JAX package.

The JAX package's initial weights (``PRNGKey(0)``) cross over through
``convert.params_from_numpy``, which unstacks ``encoder.layers`` and
``decoder.layers`` into per-layer lists; inputs are seeded numpy frames
(B, 16, 64) and tokens, and model dtype float32 throughout. Pins: the
sinusoidal table to 2e-6 absolute (the two frameworks' ``pow`` and
``sin``/``cos`` differ in their last bits, and 2e-6 covers one ulp of an
angle up to the smoke table's 64 positions); ``encode``,
``cross_attention_kv`` / ``cross_attention``, ``encdec_forward`` and the
prefill + 6 decode steps (logits, self- and cross-caches; bf16 and int8
self-cache; each decode step of both packages from JAX's caches) ≤ 1e-5
relative (Frobenius), bf16 cache cells within one bf16 ulp, int8 codes
differing in ≤ 1e-3 of the cells. One module-scoped quantize run of each
package (``MarkovLM
(vocab, seed=7)`` 3 × 4 × 32 tokens plus seeded frames; JAX with
``quant.jit_capture=false``) is held at ``tests/test_torch_pipeline.py``'s
opt-proxy pins: the same 20 linear records (the encoder's 6 a layer and
the decoder's 4 ``xattn.*`` a layer: both packages calibrate a decoder
layer's cross-attention only, ROADMAP.md §3), ``iters_run`` equal, Γ
histories ≤ 1e-3 relative, packed codes differing in ≤ 1e-2 of the bytes,
the same packed leaves (the decoder's ``layer.mixer`` / ``layer.mlp``
packed on a fresh grid) and packed-model logits ≤ 1e-3 relative; greedy
``generate`` on the JAX-packed weights gives the JAX engine's tokens with
the bf16 and the int8 self-cache. Then the port alone: a walk killed past
the ``enc→dec`` fence resumes to a bitwise-equal artifact;
``launch.quantize`` → ``launch.serve --params`` on the CPU; the artifact
holds the JAX package's stacked layers; ``xattn`` in the calibrated
subtrees changes nothing for the decoder-only architectures. Tests marked
``gpu`` (skip without a card) hold the card's run against the CPU's and
the replayed decode graph against the eager loop.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import hashlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.pipeline import pack_for_serving as jpack
from repro.core.pipeline import quantize_model as jquantize
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import (params_from_numpy, tensor_from_numpy,
                                 tree_to_numpy)
from repro_torch.core import pipeline as tpipe
from repro_torch.core import plan as tplan
from repro_torch.core.quant import QuantizedTensor, quantized_leaves
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.distributed import checkpoint as C
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine

from test_torch_kernels import bf16_ulp
from test_torch_models import rel, to_numpy

ARCH = "whisper-large-v3"
FRAMES = 16             # whisper smoke's encoder_seq_len
CALIB = (3, 4, 32)      # batches x rows x tokens, as test_torch_pipeline


def _cfgs():
    jcfg = jget_config(ARCH, smoke=True)
    tcfg = tget_config(ARCH, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    jcfg.quant.jit_capture = False
    return jcfg, tcfg


def _frames(seed, b):
    return np.random.RandomState(seed).randn(b, FRAMES, 64).astype(
        np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_encdec_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    toks = np.random.RandomState(1).randint(0, 128, size=(2, 12))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                frames=_frames(0, 2), toks=toks)


def test_convert_unstacks_encoder_and_decoder(model):
    tp, jp = model["tparams"], model["jparams"]
    assert len(tp["encoder"]["layers"]) == 2
    assert len(tp["decoder"]["layers"]) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            tp["decoder"]["layers"][i]["xattn"]["q"]["w"].numpy(),
            np.asarray(jp["decoder"]["layers"]["xattn"]["q"]["w"][i]))
        np.testing.assert_array_equal(
            tp["encoder"]["layers"][i]["mlp"]["up"]["w"].numpy(),
            np.asarray(jp["encoder"]["layers"]["mlp"]["up"]["w"][i]))


@pytest.mark.parametrize("seq,d", [(64, 64), (16, 1280)])
def test_sinusoidal_positions_match_jax(seq, d):
    got = TL.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JL.sinusoidal_positions(seq, d)),
                               rtol=0, atol=2e-6)


def test_encode_matches_jax(model):
    ej = JT.encode(model["jcfg"].model, model["jparams"],
                   jnp.asarray(model["frames"]))
    et = TT.encode(model["tcfg"].model, model["tparams"],
                   torch.from_numpy(model["frames"]))
    assert et.shape == (2, FRAMES, 64)
    assert rel(et.numpy(), ej) <= 1e-5


def test_cross_attention_matches_jax(model):
    jm, tm = model["jcfg"].model, model["tcfg"].model
    enc = np.asarray(JT.encode(jm, model["jparams"],
                               jnp.asarray(model["frames"])))
    x = np.random.RandomState(2).randn(2, 5, 64).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                model["jparams"]["decoder"]["layers"])
    tp = model["tparams"]["decoder"]["layers"][1]
    kvj = JA.cross_attention_kv(jm, jp["xattn"], jnp.asarray(enc))
    kvt = TA.cross_attention_kv(tm, tp["xattn"], torch.from_numpy(enc))
    for k in ("k", "v"):
        assert kvt[k].shape == (2, FRAMES, 4, 16)
        assert rel(kvt[k].numpy(), kvj[k]) <= 1e-5
    yj = JA.cross_attention(jm, jp["xattn"], jnp.asarray(x), kvj)
    yt = TA.cross_attention(tm, tp["xattn"], torch.from_numpy(x), kvt)
    assert rel(yt.numpy(), yj) <= 1e-5


def test_encdec_forward_matches_jax(model):
    lj, _ = JT.encdec_forward(model["jcfg"].model, model["jparams"],
                              jnp.asarray(model["frames"]),
                              jnp.asarray(model["toks"]))
    lt, _ = TT.encdec_forward(model["tcfg"].model, model["tparams"],
                              torch.from_numpy(model["frames"]),
                              torch.from_numpy(model["toks"]))
    assert lt.dtype == torch.float32 and lt.shape == (2, 12, 128)
    assert rel(lt.numpy(), lj) <= 1e-5


def _assert_caches_match(ct, cj):
    """The port's per-layer caches against JAX's stacked ones: int8 codes
    differing in ≤ 1e-3 of the cells, bf16 cells within one bf16 ulp (a
    value within fp32 rounding of a bf16 rounding boundary lands on
    either side), f32 scales within 1e-5 of the largest, error
    accumulators within 1e-5 of the largest cached value."""
    for i, layer in enumerate(ct):
        for part in ("self", "cross"):
            for name, t in layer[part].items():
                want = np.asarray(cj[part][name][i]).astype(
                    np.float32 if t.dtype != torch.int8 else np.int8)
                got = t.float().numpy() if t.dtype == torch.bfloat16 \
                    else t.numpy()
                if t.dtype == torch.int8:
                    assert np.mean(got != want) <= 1e-3, (i, part, name)
                elif t.dtype == torch.bfloat16:
                    assert np.all(np.abs(got - want) <= bf16_ulp(want)), \
                        (i, part, name)
                else:
                    # an error accumulator is held at the scale of the
                    # values it corrects: 127 times the largest scale
                    top = (127 * np.asarray(cj[part][name[0] + "_scale"][i])
                           if name.endswith("_err") else want)
                    assert np.abs(got - want).max() <= 1e-5 * np.abs(
                        top).max(), (i, part, name)


def _port_caches(cj):
    """JAX's stacked enc-dec caches as the port's per-layer list."""
    n = np.shape(cj["cross"]["k"])[0]
    return [{part: {k: tensor_from_numpy(np.asarray(v[i]))
                    for k, v in cj[part].items()}
             for part in ("self", "cross")} for i in range(n)]


@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_prefill_and_decode_match_jax(model, kv_cache):
    jm, tm = model["jcfg"].model, model["tcfg"].model
    cdt_j = "int8" if kv_cache == "int8" else jnp.bfloat16
    cdt_t = "int8" if kv_cache == "int8" else torch.bfloat16
    frames, toks = model["frames"], model["toks"]
    lj, cj = JT.encdec_prefill(jm, model["jparams"], jnp.asarray(frames),
                               jnp.asarray(toks), 20, cache_dtype=cdt_j)
    lt, ct = TT.encdec_prefill(tm, model["tparams"],
                               torch.from_numpy(frames),
                               torch.from_numpy(toks), 20, cache_dtype=cdt_t)
    assert rel(lt.numpy(), lj) <= 1e-5
    assert ct[0]["cross"]["k"].dtype == torch.bfloat16
    _assert_caches_match(ct, cj)
    nxt = np.random.RandomState(3).randint(0, 128, size=(6, 2))
    for i in range(6):
        # each step from the same caches: a bf16 or int8 cell one step
        # apart (above) moves the next logits by ~1e-4
        ct = _port_caches(cj)
        pos = np.full((2,), 12 + i, np.int32)
        lj, cj = JT.encdec_decode_step(jm, model["jparams"],
                                       jnp.asarray(nxt[i]),
                                       jnp.asarray(pos), cj)
        lt, ct = TT.encdec_decode_step(tm, model["tparams"],
                                       torch.from_numpy(nxt[i]).long(),
                                       torch.from_numpy(pos).long(), ct)
        assert rel(lt.numpy(), lj) <= 1e-5, i
        _assert_caches_match(ct, cj)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_encdec_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    jc = jcalib(JMarkovLM(128, seed=7), *CALIB)
    tc = tcalib(TMarkovLM(128, seed=7), *CALIB)
    for i, (a, b) in enumerate(zip(jc, tc)):
        fr = _frames(20 + i, CALIB[1])
        a["frames"], b["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    jq, jrep = jquantize(jcfg, jparams, jc)
    tq, trep = tpipe.quantize_model(tcfg, tparams, tc, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jc=jc, tc=tc, jq=jq, jrep=jrep,
                tq=tq, trep=trep)


def test_quantize_records_match_jax(runs):
    jl, tl = runs["jrep"].linears, runs["trep"].linears
    names = [r.name for r in tl]
    assert names == [r.name for r in jl]
    assert len(names) == 2 * 6 + 2 * 4
    assert names.count("xattn.q") == 2 and "layer.mixer.q" not in names
    for a, b in zip(tl, jl):
        assert (a.mode, a.shape) == (b.mode, tuple(b.shape)), a.name
        assert a.mode == "rpiq" and a.iters == b.iters, a.name
        n = min(len(a.gamma), len(b.gamma))
        np.testing.assert_allclose(a.gamma[:n], b.gamma[:n], rtol=1e-3)


def test_packed_layout_codes_and_logits_match_jax(runs):
    jpacked_raw = jpack(runs["jcfg"], runs["jq"])
    jpacked = params_from_numpy(to_numpy(jpacked_raw))
    tpacked = tpipe.pack_for_serving(runs["tcfg"], runs["tq"])
    ours, theirs = (dict(quantized_leaves(p)) for p in (tpacked, jpacked))
    assert list(ours) == list(theirs)
    # 2 x 6 encoder, 2 x 4 calibrated cross-attention and 2 x 6 decoder
    # self-attention and MLP linears packed on a fresh grid
    assert len(ours) == 32
    assert "decoder.layers.1.layer.mixer.q.w" in ours
    assert "decoder.layers.0.layer.mlp.down.w" in ours
    assert not any(k.endswith(("qscales", "qzeros"))
                   for k, _ in _paths(tpacked))
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    total = sum(qt.packed.numel() for qt in ours.values())
    assert diff / total <= 1e-2
    last = runs["tc"][-1]
    lt, _ = TT.encdec_forward(runs["tcfg"].model, tpacked, last["frames"],
                              last["tokens"])
    lj, _ = JT.encdec_forward(runs["jcfg"].model, jpacked_raw,
                              jnp.asarray(last["frames"].numpy()),
                              jnp.asarray(last["tokens"].numpy()))
    assert rel(lt.numpy(), lj) <= 1e-3


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}.{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_generate_greedy_tokens_equal(runs, kv_cache):
    jcfg, tcfg = runs["jcfg"], runs["tcfg"]
    jcfg.serve.kv_cache = tcfg.serve.kv_cache = kv_cache
    jpacked = jpack(jcfg, runs["jq"])
    tpacked = params_from_numpy(to_numpy(jpacked))
    prompt = JMarkovLM(128, seed=3).batch(2, 8)
    frames = _frames(30, 2)
    jr = jengine.generate(jcfg, jpacked, dict(prompt,
                                              frames=jnp.asarray(frames)),
                          max_new_tokens=6)
    tr = tengine.generate(tcfg, tpacked,
                          {"tokens": torch.from_numpy(
                              np.array(prompt["tokens"])).long(),
                           "frames": torch.from_numpy(frames)},
                          device="cpu", max_new_tokens=6)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-4, atol=1e-5)


# -- the port alone: resume across the fence, the launchers ---------------

def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _quantize(tmp, out, extra=()):
    return tlaunch_quantize.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--out",
         str(tmp / out), f"train.ckpt_dir={tmp / 'none'}",
         "quant.calib_batches=2", "quant.calib_batch_size=2",
         "quant.calib_seq_len=16"] + list(extra))


class _Interrupt(Exception):
    pass


# the walk: enc 1, enc 2 (plan calls 1, 2), the enc→dec switch (item 2),
# dec 1, dec 2 (plan calls 3, 4): a call k >= 3 is killed past the fence
@pytest.mark.parametrize("k", [3, 4])
def test_killed_past_the_fence_resumes_bitwise(k, tmp_path, monkeypatch):
    ref, _ = _quantize(tmp_path, "ref")
    ck = [f"quant.ckpt_dir={tmp_path / 'ck'}", "quant.resume=auto"]
    real, calls = tplan.execute_plan, []

    def interrupt_at_call_k(*args, **kwargs):
        calls.append(1)
        if len(calls) == k:
            raise _Interrupt(f"plan call {k}")
        return real(*args, **kwargs)

    monkeypatch.setattr(tplan, "execute_plan", interrupt_at_call_k)
    with pytest.raises(_Interrupt):
        _quantize(tmp_path, "run", ck)
    monkeypatch.setattr(tplan, "execute_plan", real)
    # the last checkpoint is the item before the killed step: the switch
    # (item 2) for k 3, dec 1 (item 3) for k 4
    assert C.Checkpointer(str(tmp_path / "ck")).latest_step() == k - 1
    path, report = _quantize(tmp_path, "run", ck)
    assert report.pipeline_stats["resumed_at"] == k
    assert report.pipeline_stats["steps"] == 4
    assert len(report.linears) == 20
    assert _sha(path) == _sha(ref)


def test_launch_quantize_then_serve_params(tmp_path, capsys):
    path, report = _quantize(tmp_path, "q")
    assert len(report.linears) == 20
    raw = C.load_artifact(path)
    # the JAX package's layout: stacked layers, a packed weight's leading
    # axis the layer
    qt = raw["decoder"]["layers"]["xattn"]["q"]["w"]
    assert qt["packed"].shape == (2, 64, 32) and list(qt["shape"]) == [
        2, 64, 64]
    assert raw["encoder"]["layers"]["norm1"]["scale"].shape == (2, 64)
    capsys.readouterr()
    res = tlaunch_serve.main(["--arch", ARCH, "--smoke", "--params", path,
                              "--batch", "2", "--prompt-len", "8",
                              "--device", "cpu", "serve.max_new_tokens=5",
                              "serve.kv_cache=int8"])
    out = capsys.readouterr().out
    seqs = [json.loads(m) for m in re.findall(r"^  seq\d+: (\[.*\])$", out,
                                               re.M)]
    assert seqs == res.tokens.tolist() and res.tokens.shape == (2, 5)
    cfg = tget_config(ARCH, smoke=True)
    cfg.serve.kv_cache = "int8"
    gen = torch.Generator()
    gen.manual_seed(3)
    batch = TMarkovLM(128, seed=3).batch(2, 8)
    batch["frames"] = torch.randn((2, FRAMES, 64), generator=gen)
    want = tengine.generate(cfg, params_from_numpy(raw), batch,
                            device="cpu", max_new_tokens=5)
    assert torch.equal(res.tokens, want.tokens)


def test_serve_feeds_frames_to_the_encoder_not_the_prompt(capsys,
                                                         monkeypatch):
    """whisper's frontend is "audio" with frontend_tokens 16, but its
    frames feed the encoder: no embeddings go in front of the prompt, so
    decode starts at the prompt length."""
    starts = []
    loop = tengine.DecodeLoop

    class Loop(loop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            starts.append(self.pos.tolist())

    seen = []
    prefill = tengine.prefill

    def recording_prefill(cfg, params, batch, max_len):
        seen.append((sorted(batch), max_len))
        return prefill(cfg, params, batch, max_len)

    monkeypatch.setattr(tengine, "DecodeLoop", Loop)
    monkeypatch.setattr(tengine, "prefill", recording_prefill)
    tlaunch_serve.main(["--arch", ARCH, "--smoke", "--pack-rtn", "--batch",
                        "2", "--prompt-len", "8", "--device", "cpu",
                        "serve.max_new_tokens=4"])
    assert starts == [[8, 8]]
    assert seen == [(["frames", "tokens"], 8 + 4 + 1)]


def test_chunked_prefill_generate_matches_jax(model):
    """``serve.prefill_chunk`` > 0 on the enc-dec: the decoder prompt in
    chunks of 4 after one encoder pass gives the JAX engine's greedy
    tokens with the same chunk (int8 self-cache)."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    for cfg in (jcfg, tcfg):
        cfg.serve.prefill_chunk, cfg.serve.kv_cache = 4, "int8"
    try:
        jr = jengine.generate(jcfg, model["jparams"],
                              {"tokens": jnp.asarray(model["toks"]),
                               "frames": jnp.asarray(model["frames"])},
                              max_new_tokens=4)
        tr = tengine.generate(tcfg, model["tparams"],
                              {"tokens": torch.from_numpy(model["toks"]),
                               "frames": torch.from_numpy(model["frames"])},
                              device="cpu", max_new_tokens=4)
    finally:
        for cfg in (jcfg, tcfg):
            cfg.serve.prefill_chunk, cfg.serve.kv_cache = 0, "fp16"
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))


def test_artifact_tree_round_trips(runs):
    packed = tpipe.pack_for_serving(runs["tcfg"], runs["tq"])
    back = params_from_numpy(tree_to_numpy(packed))
    got, want = dict(_paths(back)), dict(_paths(packed))
    assert sorted(got) == sorted(want)      # the artifact sorts its keys
    for k, v in want.items():
        if isinstance(v, QuantizedTensor):
            assert got[k].shape == v.shape
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(got[k], f), getattr(v, f)), k
        else:
            assert torch.equal(got[k], v), k


DECODER_ONLY = [a for a in ARCH_IDS if a != ARCH]


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_xattn_subtree_changes_nothing_for_decoder_only(arch, monkeypatch):
    """With ``xattn`` among the calibrated subtrees, a decoder-only model
    (which has no such subtree) calibrates and packs the same linears,
    bitwise, as with the two subtrees it had."""
    cfg = tget_config(arch, smoke=True)
    cfg.model.num_layers = 1
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cpu")
    calib = tcalib(TMarkovLM(cfg.model.vocab_size, seed=7), 1, 2, 8)
    for b in calib:
        if cfg.model.frontend_tokens:
            b["embeds"] = torch.zeros((2, 2, cfg.model.d_model))
    out = []
    for subtrees in (("mixer", "mlp"), ("mixer", "mlp", "xattn")):
        monkeypatch.setattr(tpipe, "_QUANT_SUBTREES", subtrees)
        pq, rep = tpipe.quantize_model(cfg, params, calib, device="cpu")
        out.append(([r.name for r in rep.linears],
                    dict(quantized_leaves(tpipe.pack_for_serving(cfg, pq)))))
    (names0, packed0), (names1, packed1) = out
    assert names0 == names1 and names0
    assert list(packed0) == list(packed1) and packed0
    for k, qt in packed0.items():
        assert torch.equal(qt.packed, packed1[k].packed), k


# -- on the card (skips without one) --------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke_run(device, kv_cache, dtype="float32"):
    """whisper smoke from torch seed 0, quantized, packed and served on
    ``device`` (2 requests x (16 frames + 8 tokens) + 6 new)."""
    cfg = tget_config(ARCH, smoke=True)
    cfg.model.dtype = dtype
    cfg.serve.kv_cache = kv_cache
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_encdec_params(cfg.model, gen, "cpu")
    calib = tcalib(TMarkovLM(128, seed=7), 3, 4, 32)
    for i, b in enumerate(calib):
        b["frames"] = torch.from_numpy(_frames(20 + i, 4))
    prompt = TMarkovLM(128, seed=3).batch(2, 8)
    prompt["frames"] = torch.from_numpy(_frames(30, 2))
    pq, rep = tpipe.quantize_model(cfg, params, calib, device=device)
    packed = tpipe.pack_for_serving(cfg, pq)
    res = tengine.generate(cfg, packed, prompt, device=device,
                           max_new_tokens=6)
    return cfg, rep, packed, prompt, res


@pytest.mark.gpu
@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_gpu_smoke_card_matches_cpu(cuda, kv_cache):
    """In fp32: the card's quantize → pack → generate against the CPU's
    plain run, at phase 4's pins (modes and iterations equal, packed
    bytes differing in ≤ 1e-2, greedy tokens equal)."""
    runs = {dev: _smoke_run(dev, kv_cache) for dev in ("cpu", "cuda")}
    (_, rc, pc, _, tc), (_, rg, pg, _, tg) = runs["cpu"], runs["cuda"]
    assert [(a.name, a.mode, a.iters) for a in rc.linears] == \
        [(a.name, a.mode, a.iters) for a in rg.linears]
    lin_c, lin_g = (dict(quantized_leaves(p)) for p in (pc, pg))
    assert list(lin_c) == list(lin_g) and len(lin_c) == 32
    diff = sum(int((qt.packed != lin_g[k].packed.cpu()).sum())
               for k, qt in lin_c.items())
    assert diff / sum(qt.packed.numel() for qt in lin_c.values()) <= 1e-2
    assert torch.equal(tc.tokens, tg.tokens.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_cache", ["fp16", "int8"])
def test_gpu_replay_equals_the_eager_step(cuda, kv_cache):
    """At the smoke config's own bf16 and group 16: generate's replayed
    decode graph (it holds the cross-attention caches it captured)
    against the same loop stepped eagerly: tokens and the logits of every
    step bitwise equal."""
    cfg, _, packed, prompt, res = _smoke_run("cuda", kv_cache, "bfloat16")
    inputs = {k: v.cuda() for k, v in prompt.items()}
    lg, caches = tengine.prefill(cfg, packed, inputs, 8 + 6 + 1)
    loop = tengine.DecodeLoop(cfg, packed, lg, caches, 8, 6, -1, 0.0, None)
    eager = [loop.step().clone() for _ in range(5)]
    assert torch.equal(loop.tokens, res.tokens)
    lg, caches = tengine.prefill(cfg, packed, inputs, 8 + 6 + 1)
    loop = tengine.DecodeLoop(cfg, packed, lg, caches, 8, 6, -1, 0.0, None)
    got = [loop.step().clone()]
    graph = loop.capture()
    for _ in range(4):
        graph.replay()
        got.append(loop.logits.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert torch.equal(loop.tokens, res.tokens)
