"""Serving steps: prefill and single-token decode (greedy / temperature),
as in the JAX package's ``train/serve.py``.  The model holds its
parameters, so the steps take none; a step runs eagerly (no ``jit``).  On
a grid of ranks the logits are the rank's vocabulary block: greedy
decoding takes the argmax over the blocks (``layers.vocab_argmax``, ties
to the smallest index) and sampling gathers them whole."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.model import Model


def make_prefill_step(model: Model, *, cache_len: int):
    def prefill_step(batch):
        return model.prefill(batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(model: Model, *, greedy: bool = True,
                     temperature: float = 1.0):
    """``decode_step(cache, token, pos, generator=None) -> (next (B, 1),
    cache, logits (B, V))``; sampling at ``temperature`` draws from
    ``generator`` (required when ``greedy`` is False)."""
    def decode_step(cache, token, pos, generator=None):
        logits, cache = model.decode_step(cache, token, pos)
        logits = logits[:, -1, :]
        vocab = model.cfg.padded_vocab
        if greedy:
            nxt = L.vocab_argmax(logits, vocab)
        else:
            if generator is None:
                raise ValueError("sampling needs an explicit generator")
            probs = torch.softmax(
                L.vocab_whole(logits, vocab).float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt.to(torch.int32)[:, None], cache, logits

    return decode_step


@torch.no_grad()
def generate(model: Model, prompt_tokens, *, steps: int,
             cache_len: int | None = None, batch_extra=None):
    """Greedy generation: the prefill's next token, then ``steps − 1``
    decode steps.  Returns (B, steps) int32 tokens."""
    b, s = prompt_tokens.shape
    cache_len = cache_len or (s + steps)
    batch = {"tokens": prompt_tokens}
    if batch_extra:
        batch.update(batch_extra)
    logits, cache = make_prefill_step(model, cache_len=cache_len)(batch)
    tok = L.vocab_argmax(logits[:, -1, :], model.cfg.padded_vocab).to(
        torch.int32)[:, None]
    return decode_from(model, cache, tok, s, steps)


@torch.no_grad()
def decode_from(model: Model, cache, tok, pos: int, steps: int):
    """``steps − 1`` greedy decode steps after ``tok`` (the token at
    position ``pos``); returns (B, steps) with ``tok`` first."""
    decode = make_decode_step(model)
    out = [tok]
    for i in range(steps - 1):
        tok, cache, _ = decode(cache, tok, pos + i)
        out.append(tok)
    return torch.cat(out, dim=1)
