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

Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks form a
``dist.sharding.RankGrid`` (``--model-parallel``, ``--backend`` gloo so
that ranks may share a card, nccl for a card a rank) under the
``"serve"`` rules: the weights replicate over data and
split over ``model`` (heads, the FFN's hidden dim, the vocabulary, a
MoE's experts), every rank draws the same prompts and keeps its rows (its
data shard when the data axis divides ``--batch``, else all of them), and
every rank of a data row decodes the same tokens (the argmax over the
vocabulary's blocks).  Rank 0 prints; each rank returns its rows'
tokens::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --reduced --batch 2 --prompt-len 64
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch.graph_serve import card_line
from repro_torch.launch.mesh import make_host_mesh, make_rank_grid, world_size
from repro_torch.models import layers as L
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
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="the grid's model axis under torchrun")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the process group's backend under torchrun")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    grid = None
    if world_size() > 1:
        grid = make_rank_grid(args.model_parallel, args.backend,
                              device=args.device, strategy="serve")
        dev, mesh = grid.device, grid
    else:
        dev, mesh = resolve_device(args.device), make_host_mesh()
    model = Model(cfg, device=dev, mesh=grid).init(
        torch.Generator(device=dev).manual_seed(args.seed))
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
    if grid is not None:  # this rank's rows
        batch = {k: grid.local_rows(v) for k, v in batch.items()}
    cache_len = args.prompt_len + args.gen
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with shd.activation_sharding(mesh, rules, batch=args.batch):
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(model, cache_len=cache_len)(batch)
        tok = L.vocab_argmax(logits[:, -1, :], cfg.padded_vocab).to(
            torch.int32)[:, None]
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = decode_from(model, cache, tok, args.prompt_len, args.gen)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    steps = args.gen - 1
    if grid is not None and grid.rank != grid.leader:
        return out
    where = "" if grid is None else f" on a {dict(grid.shape)} grid"
    print(f"{cfg.name}: {model.num_params():,} parameters{where}; prefill "
          f"{args.batch}×{args.prompt_len} in {t_prefill:.3f}s; decode "
          f"{steps} steps in {t_decode:.3f}s "
          f"({1e3 * t_decode / max(steps, 1):.2f} ms a step, "
          f"{steps * args.batch / max(t_decode, 1e-9):.1f} tok/s); peak "
          f"{peak / 2**30:.2f} GiB on {card_line(args.device)}")
    print("generated ids (first row):", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
