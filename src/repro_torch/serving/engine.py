"""Static-batch serving engine: prefill, then one token per step.

Weights may be float or int4-packed (``QuantizedTensor`` leaves from
``pack_for_serving``); ``models.linear.dense`` dispatches per leaf, so the
packed denses run the W4A16 kernel on the card. ``serve.kv_cache=int8``
keeps the decode history as int8 codes read by the int8 KV attention
kernel. A Mamba layer carries a recurrent state instead of a KV cache: the
prefill runs the selective-scan kernel and hands its last state and conv
inputs to the plain single-step recurrence of decode, which returns a new
state each step. Finished lanes keep decoding but their outputs are
frozen.

EOS convention (as in the JAX engine): the eos token itself is never
emitted. The step that samples eos writes token 0 / logprob 0.0 and marks
the lane done, so ``tokens[b, :steps[b]]`` is the usable output.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.config import Config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

Tensor = torch.Tensor


class GenResult(NamedTuple):
    tokens: Tensor          # (B, max_new) generated ids (0 on done lanes)
    logprobs: Tensor        # (B, max_new)
    steps: Tensor           # (B,) tokens actually produced (pre-eos)


def cache_dtype(cfg: Config) -> Union[torch.dtype, str]:
    """Decode-cache precision from ``serve.kv_cache``: ``"int8"`` (codes +
    scales, models/attention.py) or bf16."""
    return "int8" if cfg.serve.kv_cache == "int8" else torch.bfloat16


def prefill(cfg: Config, params: Any, batch: Dict[str, Tensor],
            max_len: int) -> Tuple[Tensor, List[Dict]]:
    """Prefill from ``{"tokens": (B, S)}`` into caches of max_len, in the
    precision ``serve.kv_cache`` names."""
    return T.prefill(cfg.model, params, batch["tokens"], max_len,
                     cache_dtype=cache_dtype(cfg))


def serve_step(cfg: Config, params: Any, token: Tensor, pos: Tensor,
               caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One decode step. token/pos: (B,)."""
    return T.decode_step(cfg.model, params, token, pos, caches)


def _sample(logits: Tensor, temperature: float,
            gen: Optional[torch.Generator]) -> Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def _params_device(params: Dict) -> torch.device:
    return params["embed"]["embedding"].device


@torch.no_grad()
def generate(cfg: Config, params: Any, batch: Dict[str, Tensor],
             device: Union[str, torch.device, None] = None, *,
             max_new_tokens: Optional[int] = None, eos_id: int = -1,
             temperature: Optional[float] = None,
             seed: int = 0) -> GenResult:
    """Greedy (temperature 0) or sampled generation over a static batch.

    Runs on the CUDA card unless ``device="cpu"``; params must already be
    on that device. Sampling draws from a ``torch.Generator`` seeded with
    ``seed``."""
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
    tokens = batch["tokens"].to(_params_device(params))
    b, s0 = tokens.shape
    logits, caches = prefill(cfg, params, {"tokens": tokens}, s0 + mnt + 1)
    ar = torch.arange(b, device=tokens.device)

    def pick(lg: Tensor, done: Tensor):
        raw = _sample(lg, temp, gen)
        lp = torch.log_softmax(lg, dim=-1)[ar, raw]
        newly_done = done | (raw == eos_id)
        tok = torch.where(newly_done, torch.zeros_like(raw), raw)
        return tok, torch.where(newly_done, torch.zeros_like(lp), lp), \
            newly_done

    done = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    tok, lp, done = pick(logits, done)
    out_t, out_lp, steps = [tok], [lp], (~done).to(torch.int32)
    pos = torch.full((b,), s0, dtype=torch.long, device=tokens.device)
    for _ in range(mnt - 1):
        lg, caches = serve_step(cfg, params, tok, pos, caches)
        tok, lp, done = pick(lg, done)
        out_t.append(tok)
        out_lp.append(lp)
        steps = steps + (~done).to(torch.int32)
        pos = pos + 1
    return GenResult(torch.stack(out_t, dim=1), torch.stack(out_lp, dim=1),
                     steps)
