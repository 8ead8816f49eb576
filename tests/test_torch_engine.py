"""The port's decode loop: in-place static buffers, and its CUDA graph.

CPU (smoke configs, model dtype float32, the JAX package's initial weights
carried across by ``convert.params_from_numpy``): ``generate`` — the static-
buffer ``DecodeLoop`` stepped as a plain call — gives the JAX engine's
greedy tokens and steps exactly, and its logprobs to 1e-4 relative, for
opt-proxy (bf16 cache), internlm2-1.8b (int8 KV cache) and falcon-mamba-7b
(recurrent state), also with an eos that stops a lane. A decode step
writes the Mamba state into the tensors the prefill allocated (same
``data_ptr``), bitwise the values of the returning step it replaced (kept
here as the oracle). Sampled ``generate`` repeats under one seed, and the
exponential race it samples with follows the softmax (5000 draws a row,
within 0.03 of each probability).

``gpu`` (skip without a card; ``python -m pytest -m gpu
tests/test_torch_engine.py``): on each smoke config, quantized and packed
on the card, the replayed graph's logits equal the eager steps' bitwise
and its greedy tokens equal the eager loop's; the launch counters read
what the eager loop counts (replays x the launches captured); a graph
survives a later, larger ``int8_kv_attention`` call that replaces the
workspace; a step that cannot be captured makes ``generate`` raise; and
sampled ``generate`` repeats under one seed while successive replays draw
new tokens.
"""
import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.data import MarkovLM as JMarkovLM
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine

ARCHS = [("opt-proxy", "fp16"), ("internlm2-1.8b", "int8"),
         ("falcon-mamba-7b", "fp16")]
ARCH_IDS = ["opt-proxy", "internlm2-int8", "falcon-mamba"]


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)),
                                  tree)


def _setup(arch, kv_cache, dtype="float32"):
    jcfg = jget_config(arch, smoke=True)
    tcfg = tget_config(arch, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = dtype
    jcfg.serve.kv_cache = tcfg.serve.kv_cache = kv_cache
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    prompt = JMarkovLM(tcfg.model.vocab_size, seed=3).batch(2, 8)
    return jcfg, tcfg, jparams, tparams, prompt


def _tokens(prompt):
    return {"tokens": torch.from_numpy(np.array(prompt["tokens"])).long()}


@pytest.mark.parametrize("arch,kv_cache", ARCHS, ids=ARCH_IDS)
def test_generate_greedy_tokens_equal_jax(arch, kv_cache):
    jcfg, tcfg, jparams, tparams, prompt = _setup(arch, kv_cache)
    jr = jengine.generate(jcfg, jparams, prompt, max_new_tokens=6)
    tr = tengine.generate(tcfg, tparams, _tokens(prompt), device="cpu",
                          max_new_tokens=6)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-4, atol=1e-5)
    # an eos that lane 0 samples at its third token: the lane stops there,
    # writes 0 from then on and counts two steps
    eos = int(jr.tokens[0, 2])
    jr = jengine.generate(jcfg, jparams, prompt, max_new_tokens=6,
                          eos_id=eos)
    tr = tengine.generate(tcfg, tparams, _tokens(prompt), device="cpu",
                          max_new_tokens=6, eos_id=eos)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    assert int(tr.steps[0]) == 2 and not tr.tokens[0, 2:].any()


def _returning_mamba_decode(cfg, p, x, state):
    """The decode step as it was before it wrote in place: a new state
    from every call (the oracle of the in-place step)."""
    from repro_torch.models.layers import causal_conv1d
    u, z = TR._split_in(cfg, p, x, "mixer")
    u, conv_state = causal_conv1d(p["conv"], u, state["conv"])
    conv_state = conv_state.clone()
    u = F.silu(u)
    a, b, cm = TR._mamba_ssm_inputs(cfg, p, u, "mixer")
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0])
    y = y + u[:, 0].float() * p["d_skip"].float()
    y = y.to(x.dtype).float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = TR.dense(p["out"], y[:, None, :], "mixer.out")
    return out, {"conv": conv_state, "h": h.to(x.dtype)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_writes_the_prefill_state_in_place(dtype):
    _, tcfg, _, tparams, prompt = _setup("falcon-mamba-7b", "fp16", dtype)
    mc = tcfg.model
    toks = _tokens(prompt)["tokens"]
    _, caches = TT.prefill(mc, tparams, toks, 12)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in caches]
    oracle = copy.deepcopy(caches)
    tok = toks[:, -1]
    pos = torch.full((2,), 8, dtype=torch.long)
    for _ in range(3):
        lg, out = TT.decode_step(mc, tparams, tok, pos, caches)
        assert out is caches
        h = TT.embed(tparams["embed"], tok[:, None], TT.compute_dtype(mc))
        for i, (spec, p) in enumerate(zip(TT.layer_specs(mc),
                                          tparams["layers"])):
            y, oracle[i] = _returning_mamba_decode(
                mc, p["mixer"], TT.norm(mc, p["norm1"], h), oracle[i])
            h = h + y
        want = TT.unembed(mc, tparams,
                          TT.norm(mc, tparams["final_norm"], h))[:, 0]
        assert torch.equal(lg, want)
        for c, o, ptr in zip(caches, oracle, ptrs):
            for k in ("conv", "h"):
                assert c[k].data_ptr() == ptr[k]
                assert c[k].dtype == getattr(torch, dtype)
                assert torch.equal(c[k], o[k])
        tok = torch.argmax(lg, -1)
        pos = pos + 1


@pytest.mark.parametrize("arch,kv_cache", ARCHS[::2], ids=ARCH_IDS[::2])
def test_sampled_generate_repeats_under_one_seed(arch, kv_cache):
    _, tcfg, _, tparams, prompt = _setup(arch, kv_cache)
    runs = [tengine.generate(tcfg, tparams, _tokens(prompt), device="cpu",
                             max_new_tokens=8, temperature=1.0, seed=s)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].logprobs, runs[1].logprobs)
    assert not torch.equal(runs[0].tokens, runs[2].tokens)


def test_exponential_race_follows_the_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0], [3.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator()
    gen.manual_seed(0)
    n = 5000
    draws = torch.stack([tengine._sample(logits, 0.7, gen)
                         for _ in range(n)], dim=1)
    want = torch.softmax(logits / 0.7, dim=-1)
    for row in range(2):
        freq = torch.bincount(draws[row], minlength=4).float() / n
        assert float((freq - want[row]).abs().max()) <= 0.03


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed_on_card(arch, kv_cache):
    """The smoke config at its own dtype and group size, quantized and
    packed on the card from seeded weights, and a (2, 8) prompt."""
    from repro_torch.core.pipeline import pack_for_serving, quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    cfg = tget_config(arch, smoke=True)
    cfg.serve.kv_cache = kv_cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cuda")
    calib = calibration_batches(MarkovLM(cfg.model.vocab_size, seed=7), 2,
                                2, 32)
    params_q, _ = quantize_model(cfg, params, calib)
    packed = pack_for_serving(cfg, params_q)
    prompt = MarkovLM(cfg.model.vocab_size, seed=3).batch(2, 8)
    return cfg, packed, prompt["tokens"].cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_cache", ARCHS, ids=ARCH_IDS)
def test_gpu_replay_equals_the_eager_step(cuda, arch, kv_cache):
    cfg, packed, toks = _packed_on_card(arch, kv_cache)
    mc, n_steps = cfg.model, 9
    max_len = toks.shape[1] + n_steps + 2
    # the eager loop on its own caches
    lg, caches = tengine.prefill(cfg, packed, {"tokens": toks}, max_len)
    tok = torch.argmax(lg, -1)
    pos = torch.full((2,), toks.shape[1], dtype=torch.long, device=cuda)
    eager, eager_toks = [], [tok]
    for _ in range(n_steps):
        lg, caches = TT.decode_step(mc, packed, tok, pos, caches)
        tok = torch.argmax(lg, -1)
        eager.append(lg.clone())
        eager_toks.append(tok)
        pos = pos + 1
    # the loop: one eager step, then replays of the captured step
    lg, caches = tengine.prefill(cfg, packed, {"tokens": toks}, max_len)
    loop = tengine.DecodeLoop(cfg, packed, lg, caches, toks.shape[1],
                              n_steps + 1, -1, 0.0, None)
    got = [loop.step().clone()]
    graph = loop.capture()
    for _ in range(n_steps - 1):
        graph.replay()
        got.append(loop.logits.clone())
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    assert torch.equal(loop.tokens, torch.stack(eager_toks, dim=1))


@pytest.mark.gpu
def test_gpu_graph_counts_replays_times_captured(cuda):
    cfg, packed, toks = _packed_on_card("internlm2-1.8b", "int8")
    mnt = 7
    ops.reset_kernel_launches()
    lg, caches = tengine.prefill(cfg, packed, {"tokens": toks},
                                 toks.shape[1] + mnt + 1)
    loop = tengine.DecodeLoop(cfg, packed, lg, caches, toks.shape[1], mnt,
                              -1, 0.0, None)
    for _ in range(mnt - 1):
        loop.step()
    eager = ops.kernel_launches()
    ops.reset_kernel_launches()
    res = tengine.generate(cfg, packed, {"tokens": toks}, max_new_tokens=mnt)
    assert ops.kernel_launches() == eager
    assert torch.equal(res.tokens, loop.tokens)
    assert res.capture_s > 0
    # one step's launches, captured once, counted per replay
    layers = cfg.model.num_layers
    assert eager["int8_kv_attention"] == layers * (mnt - 1)


@pytest.mark.gpu
def test_gpu_graph_survives_a_larger_int8_kv_attention_call(cuda):
    from repro_torch.kernels import ref

    def case(b, s, seed):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        q = torch.randn((b, 8, 2, 128), generator=gen, device=cuda)
        codes = [torch.randint(-127, 128, (b, s, 8, 128), generator=gen,
                               device=cuda, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand((b, s, 8, 1), generator=gen, device=cuda)
                  * 0.01 for _ in range(2)]
        kpos = torch.arange(s, device=cuda, dtype=torch.int32)[None].expand(
            b, s).contiguous()
        return q, codes[0], scales[0], codes[1], scales[1], kpos

    small = case(2, 545, 1)
    ops.int8_kv_attention(*small, kv_block=128)      # the workspace exists
    graph = ops.CapturedCall(
        lambda: ops.int8_kv_attention(*small, kv_block=128))
    before = ops._KV_WORK[cuda.index or 0][2]
    ops.int8_kv_attention(*case(8, 4096, 2), kv_block=128)
    assert ops._KV_WORK[cuda.index or 0][2] != before   # replaced
    # the replaced workspace's memory, reused by new allocations
    junk = [torch.full((1 << 20,), 7, dtype=torch.int32, device=cuda)
            for _ in range(8)]
    graph.replay(3)
    torch.cuda.synchronize()
    want = ref.int8_kv_attention(*small, 128)
    assert float((graph.out - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    del junk


@pytest.mark.gpu
def test_gpu_a_step_that_cannot_be_captured_raises(cuda, monkeypatch):
    cfg, packed, toks = _packed_on_card("opt-proxy", "fp16")
    real = tengine.serve_step

    def syncing_step(*args):
        lg, caches = real(*args)
        float(lg[0, 0])           # a host sync: refused while capturing
        return lg, caches

    monkeypatch.setattr(tengine, "serve_step", syncing_step)
    with pytest.raises(RuntimeError):
        tengine.generate(cfg, packed, {"tokens": toks}, max_new_tokens=6)


@pytest.mark.gpu
def test_gpu_sampled_generate_repeats_and_replays_draw_anew(cuda):
    cfg, packed, toks = _packed_on_card("opt-proxy", "fp16")
    # a zero lm_head: flat logits, every token equally likely
    flat = dict(packed, lm_head={"w": torch.zeros_like(
        packed["lm_head"]["w"])})
    runs = [tengine.generate(cfg, flat, {"tokens": toks}, max_new_tokens=12,
                             temperature=1.0, seed=s) for s in (3, 3, 4)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert not torch.equal(runs[0].tokens, runs[2].tokens)
    # steps 2..11 are replays: each lane's tokens there are not one draw
    for lane in runs[0].tokens[:, 2:]:
        assert len(set(lane.tolist())) > 5
