"""The assigned input-shape set (same four cells for every LM arch).

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prompt pass;
``decode_*`` / ``long_*`` lower ``serve_step`` — ONE new token against a KV
cache of ``seq_len``. ``long_500k`` requires sub-quadratic attention and is
skipped for pure softmax-attention archs (noted in DESIGN.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}
