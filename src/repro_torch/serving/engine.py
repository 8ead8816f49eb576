"""Static-batch serving engine: prefill, then one token per step.

Weights may be float or int4-packed (``QuantizedTensor`` leaves from
``pack_for_serving``); ``models.linear.dense`` dispatches per leaf, so the
packed denses run the W4A16 kernel on the card. ``serve.kv_cache=int8``
keeps the decode history as int8 codes read by the int8 KV attention
kernel. A Mamba layer carries a recurrent state instead of a KV cache: the
prefill runs the selective-scan kernel and hands its last state and conv
inputs to the plain single-step recurrence of decode. An encoder-decoder
(whisper) takes a batch's ``frames``: its prefill runs the encoder and
fills each decoder layer's cross-attention cache once, and every decode
step reads those caches (a captured step holds the ones it captured).
Finished lanes keep decoding but their outputs are frozen.

The decode loop is the twin of the JAX engine's ``lax.scan`` over
``serve_step``: :class:`DecodeLoop` keeps the token, position, done and
step buffers, the output rows and the caches in place, and its step writes
into them. On the card ``generate`` runs the first step eagerly (kernel
builds, library handles and workspaces are made there), captures one step
into a CUDA graph and replays it for every later token, with no host sync
until the end; a capture that fails raises. The graph is captured anew for
each call (its buffers are the call's own caches). On the CPU the same
step runs as a plain call.

``serve.prefill_chunk > 0`` prefills the prompt that many positions at a
time (logits and caches those of the single-shot prefill); the
incremental pieces :func:`prefill_begin`, :func:`prefill_step` and
:func:`prefill_finish`, and :func:`decode_step_guarded` (the greedy pick
fused with a finite-logits flag), serve the continuous engine
(serving/scheduler.py).

EOS convention (as in the JAX engine): the eos token itself is never
emitted. The step that samples eos writes token 0 / logprob 0.0 and marks
the lane done, so ``tokens[b, :steps[b]]`` is the usable output.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.config import Config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

Tensor = torch.Tensor


class GenResult(NamedTuple):
    tokens: Tensor          # (B, max_new) generated ids (0 on done lanes)
    logprobs: Tensor        # (B, max_new)
    steps: Tensor           # (B,) tokens actually produced (pre-eos)
    capture_s: float = 0.0  # wall of the decode step's graph capture


def cache_dtype(cfg: Config) -> Union[torch.dtype, str]:
    """Decode-cache precision from ``serve.kv_cache``: ``"int8"`` (codes +
    scales, models/attention.py) or bf16."""
    return "int8" if cfg.serve.kv_cache == "int8" else torch.bfloat16


def prefill(cfg: Config, params: Any, batch: Dict[str, Tensor],
            max_len: int) -> Tuple[Tensor, List[Dict]]:
    """Prefill from ``{"tokens": (B, S), "embeds"?: (B, F, D)}`` (frontend
    embeddings in front of the tokens), or for an encoder-decoder
    ``{"tokens": (B, S), "frames": (B, Se, D)}``, into caches of max_len,
    in the precision ``serve.kv_cache`` names; in chunks of
    ``serve.prefill_chunk`` positions when that is > 0."""
    chunk, cdt = cfg.serve.prefill_chunk, cache_dtype(cfg)
    if cfg.model.is_encoder_decoder:
        if chunk > 0:
            return T.encdec_prefill_chunked(cfg.model, params,
                                            batch["frames"], batch["tokens"],
                                            max_len, chunk, cache_dtype=cdt)
        return T.encdec_prefill(cfg.model, params, batch["frames"],
                                batch["tokens"], max_len, cache_dtype=cdt)
    if chunk > 0:
        return T.prefill_chunked(cfg.model, params, batch["tokens"], max_len,
                                 chunk, cache_dtype=cdt,
                                 embeds=batch.get("embeds"))
    return T.prefill(cfg.model, params, batch["tokens"], max_len,
                     cache_dtype=cdt, embeds=batch.get("embeds"))


def prefill_begin(cfg: Config, params: Any, batch: Dict[str, Tensor],
                  max_len: int) -> Tuple[Tensor, List[Dict]]:
    """The incremental prefill's start: the embedded inputs ``h`` and
    empty caches (an encoder-decoder's encoder runs here, once)."""
    cdt = cache_dtype(cfg)
    if cfg.model.is_encoder_decoder:
        return T.encdec_prefill_begin(cfg.model, params, batch["frames"],
                                      batch["tokens"], max_len,
                                      cache_dtype=cdt)
    return T.prefill_begin(cfg.model, params, batch["tokens"], max_len,
                           cache_dtype=cdt, embeds=batch.get("embeds"))


def prefill_step(cfg: Config, params: Any, h_chunk: Tensor, start: int,
                 caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One prefill chunk at positions [start, start + C)."""
    if cfg.model.is_encoder_decoder:
        return T.encdec_prefill_step(cfg.model, params, h_chunk, start,
                                     caches)
    return T.prefill_step(cfg.model, params, h_chunk, start, caches)


def prefill_finish(cfg: Config, params: Any, h_last: Tensor) -> Tensor:
    """Next-token logits from the last chunk's output."""
    if cfg.model.is_encoder_decoder:
        return T.encdec_prefill_finish(cfg.model, params, h_last)
    return T.prefill_finish(cfg.model, params, h_last)


def serve_step(cfg: Config, params: Any, token: Tensor, pos: Tensor,
               caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One decode step. token/pos: (B,)."""
    if cfg.model.is_encoder_decoder:
        return T.encdec_decode_step(cfg.model, params, token, pos, caches)
    return T.decode_step(cfg.model, params, token, pos, caches)


def decode_step_guarded(cfg: Config, params: Any, token: Tensor,
                        pos: Tensor, caches: List[Dict]
                        ) -> Tuple[Tensor, Tensor, List[Dict]]:
    """The greedy decode step with a fused finite-logits flag: returns
    (next token (B,), ok (B,) bool, caches); ``ok`` is False on a lane
    whose logits went non-finite (a poisoned cache lane), which the
    continuous engine quarantines. No host sync, so a CUDA graph holds
    it."""
    lg, caches = serve_step(cfg, params, token, pos, caches)
    ok = torch.isfinite(lg).all(dim=-1)
    return torch.argmax(lg, dim=-1), ok, caches


def _sample(logits: Tensor, temperature: float,
            gen: Optional[torch.Generator]) -> Tensor:
    """argmax at temperature 0; else one draw from softmax(logits / T) as
    the argmax of p / e, e ~ Exp(1) from ``gen`` (the exponential race, a
    categorical draw without a host sync, so a CUDA graph can hold it)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return torch.argmax(probs / race, dim=-1)


def _params_device(params: Dict) -> torch.device:
    return params["embed"]["embedding"].device


class DecodeLoop:
    """The decode loop of one ``generate`` call over static buffers.

    Built from the prefill's logits and caches, it picks token 0 and holds
    the token, position, done and step counts, a device-side step index
    and the (B, max_new) output rows; :meth:`step` runs ``serve_step`` and
    the pick, writing every result into those buffers (the caches are
    updated in place), so the step can be captured once and replayed.
    ``logits`` holds the last step's logits."""

    def __init__(self, cfg: Config, params: Any, logits: Tensor,
                 caches: List[Dict], s0: int, max_new: int, eos_id: int,
                 temperature: float, gen: Optional[torch.Generator]):
        self.cfg, self.params, self.caches = cfg, params, caches
        self.eos_id, self.temp, self.gen = eos_id, temperature, gen
        dev = logits.device
        b = logits.shape[0]
        self.ar = torch.arange(b, device=dev)
        self.tokens = torch.zeros((b, max_new), dtype=torch.long, device=dev)
        self.logprobs = torch.zeros((b, max_new), dtype=torch.float32,
                                    device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.idx = torch.zeros(1, dtype=torch.long, device=dev)
        self.steps = torch.zeros(b, dtype=torch.int32, device=dev)
        self.pos = torch.full((b,), s0, dtype=torch.long, device=dev)
        self.tok = torch.zeros(b, dtype=torch.long, device=dev)
        self.logits = logits
        self._pick(logits)

    def _pick(self, lg: Tensor) -> None:
        raw = _sample(lg, self.temp, self.gen)
        lp = torch.log_softmax(lg, dim=-1)[self.ar, raw]
        done = self.done | (raw == self.eos_id)
        tok = torch.where(done, torch.zeros_like(raw), raw)
        lp = torch.where(done, torch.zeros_like(lp), lp)
        self.tokens.index_copy_(1, self.idx, tok[:, None])
        self.logprobs.index_copy_(1, self.idx, lp[:, None].float())
        self.steps.add_((~done).to(torch.int32))
        self.done.copy_(done)
        self.tok.copy_(tok)
        self.idx.add_(1)

    def step(self) -> Tensor:
        """One decode step on the static buffers; returns its logits."""
        self.logits, _ = serve_step(self.cfg, self.params, self.tok,
                                    self.pos, self.caches)
        self._pick(self.logits)
        self.pos.add_(1)
        return self.logits

    def capture(self) -> ops.CapturedCall:
        """The step captured into a CUDA graph (its launch counts, memory
        pool and int8_kv_attention workspaces in the returned object);
        ``logits`` then holds each replay's logits."""
        return ops.CapturedCall(self.step, [self.gen] if self.gen else [])

    def result(self, capture_s: float = 0.0) -> GenResult:
        return GenResult(self.tokens, self.logprobs, self.steps, capture_s)


@torch.no_grad()
def generate(cfg: Config, params: Any, batch: Dict[str, Tensor],
             device: Union[str, torch.device, None] = None, *,
             max_new_tokens: Optional[int] = None, eos_id: int = -1,
             temperature: Optional[float] = None,
             seed: int = 0) -> GenResult:
    """Greedy (temperature 0) or sampled generation over a static batch.

    Runs on the CUDA card unless ``device="cpu"``; params must already be
    on that device. On the card the decode steps after the first replay
    one captured CUDA graph (module docstring). Sampling draws from a
    ``torch.Generator`` seeded with ``seed``. A batch's ``embeds`` (B, F,
    D) go in front of its tokens, so decode starts at position S + F; an
    encoder-decoder's ``frames`` (B, Se, D) feed its encoder, and its
    decoder starts at S."""
    dev = resolve_device(device)
    if _params_device(params).type != dev.type:
        raise ValueError(f"params live on {_params_device(params)}, "
                         f"generate was asked to run on {dev}")
    sc = cfg.serve
    mnt = max_new_tokens or sc.max_new_tokens
    temp = sc.temperature if temperature is None else temperature
    gen = None
    if temp > 0:
        gen = torch.Generator(device=_params_device(params))
        gen.manual_seed(seed)
    inputs = {k: batch[k].to(_params_device(params))
              for k in ("tokens", "embeds", "frames")
              if batch.get(k) is not None}
    s0 = inputs["tokens"].shape[1]
    n_front = inputs["embeds"].shape[1] if "embeds" in inputs else 0
    logits, caches = prefill(cfg, params, inputs, s0 + n_front + mnt + 1)
    loop = DecodeLoop(cfg, params, logits, caches, s0 + n_front, mnt,
                      eos_id, temp, gen)
    if mnt > 1:
        loop.step()
    if dev.type != "cuda" or mnt <= 2:
        for _ in range(mnt - 2):
            loop.step()
        return loop.result()
    t = time.perf_counter()
    graph = loop.capture()
    capture_s = time.perf_counter() - t
    graph.replay(mnt - 2)
    return loop.result(capture_s)
