"""Serving launcher: prefill + batched greedy decode, as in the JAX package's
``launch/serve.py``, on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 2 --prompt-len 4096 --gen 32

The parameters are made from ``--seed`` on the device (no weights are
read), and so are the stub frontends' inputs (patch embeddings, the
encoder-decoder's frames).  On the card the prefill runs through the flash attention and SSD
chunk kernels; ``--device cpu`` runs their plain versions (``--reduced``
makes that feasible).  It prints the prefill and decode times, the
tokens/s and the peak allocation beside the card's name and power limit
as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch.graph_serve import card_line
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.train.serve import decode_from, make_prefill_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    mesh = make_host_mesh()
    rules = shd.make_rules(mesh, strategy="serve")

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patch_embeds"] = 0.02 * torch.randn(
            (args.batch, min(cfg.num_patches, args.prompt_len), cfg.d_model),
            generator=gen, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev)
    cache_len = args.prompt_len + args.gen
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with shd.activation_sharding(mesh, rules):
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(model, cache_len=cache_len)(batch)
        tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decode_from(model, cache, tok, args.prompt_len, args.gen)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    steps = args.gen - 1
    print(f"{cfg.name}: {model.num_params():,} parameters; prefill "
          f"{args.batch}×{args.prompt_len} in {t_prefill:.3f}s; decode "
          f"{steps} steps in {t_decode:.3f}s "
          f"({1e3 * t_decode / max(steps, 1):.2f} ms a step, "
          f"{steps * args.batch / max(t_decode, 1e-9):.1f} tok/s); peak "
          f"{peak / 2**30:.2f} GiB on {card_line(args.device)}")
    print("generated ids (first row):", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
