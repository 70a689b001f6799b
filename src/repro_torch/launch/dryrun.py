"""Dry run: trace every (arch × shape) cell's step once on the meta device
and account for it, as the JAX package's ``launch/dryrun.py`` lowers and
compiles each cell.

Per cell this driver:
  1. builds the step as ``launch/train.py`` and ``launch/serve.py`` do
     (:func:`build_step`): the model on ``device="meta"`` through
     ``kernel="cuda"`` — the card's path, whose kernel launches are planned,
     never made — with its inputs from ``launch/specs.py`` (no allocation);
  2. runs it once under ``op_analysis.OpCounter`` (the train step's
     microbatch loop sampled by ``kernels/accounting.trips`` and weighed to
     its count);
  3. records the per-step dot FLOPs and bytes, the bytes every op
     accesses, the planned kernel
     launches, the collective wire bytes (0 on one card), the memory —
     ``argument_bytes`` (parameters, their compute-dtype copies, optimizer
     state, batch, cache), ``temp_bytes`` (the step's peak allocation above
     them), ``output_bytes`` (what it leaves allocated) and their sum
     ``peak_estimate_bytes`` — and whether that fits the card;
  4. writes ``results/dryrun_torch/<arch>__<shape>__h100x1.json`` and the
     op trace beside it (``.ops.json.gz``; ``launch/reanalyze.py`` re-reads
     it).

The roofline's rates are one H100's (NVIDIA's data sheet, SXM, dense):
989 TFLOP/s in bf16 on the tensor cores, 495 in TF32, 67 in float32 off
them, 3.35 TB/s of HBM; the compute term takes the cell's compute dtype
(float32 matmuls run without TF32 in the port).  The card's memory is read
from the card (``torch.cuda.get_device_properties``) and written with its
name and power limit; without a card, ``fits`` is null.

Across a grid of ranks (``--single-pod``: JAX's default 16×16 ``("data",
"model")``, 256 ranks; ``--multi-pod``: 2×16×16 ``("pod", "data",
"model")``, 512; ``--strategy 2d|fsdp|serve`` the rule table, and a
strategy other than ``2d`` alone selects 16×16) the step is built for rank
0 of a ``dist.sharding.TracedGrid`` — the code the real ranks run, each
parameter the rank's block under the grid's rules — and the record is one
rank's: its argument, temp and peak bytes against one card's memory, its
dot FLOPs, planned launches and the collectives it takes part in, by kind
and by grid axis (NCCL's ring wire bytes).  The roofline's collective term
is the sum over axes of bytes / rate, at the DGX H100 data sheet's rates:
NVLink 450 GB/s a direction between the 8 GPUs of a node, InfiniBand NDR
400 Gb/s (50 GB/s) a GPU between nodes; a group whose ranks (row-major,
8 to a node) span nodes takes the InfiniBand rate.  They are the data
sheet's, not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-2.7b \\
      --shape train_4k --reduced
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 32 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --multi-pod [--strategy fsdp]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config, get_reduced,
                                 shape_cells)
from repro_torch.dist import sharding as shd
from repro_torch.launch import op_analysis
from repro_torch.launch.graph_serve import card_line
from repro_torch.launch.specs import batch_specs, choose_microbatches
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.serve import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESH = "h100x1"
#: the grids of ranks: mesh tag → shape (JAX's production meshes)
GRIDS = {"h100_16x16": {"data": 16, "model": 16},
         "h100_2x16x16": {"pod": 2, "data": 16, "model": 16}}

# one H100 (SXM): dense peak rates by compute dtype, HBM and NVLink
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction
# a GPU's InfiniBand NDR port between nodes: 400 Gb/s
IB_BW = 50e9  # bytes/s
LINK_RATES = {"nvlink": NVLINK_BW, "infiniband": IB_BW}
RATES_SOURCE = ("NVIDIA DGX H100 data sheet: NVLink 900 GB/s bidirectional "
                "(450 GB/s a direction) between a node's 8 GPUs; 8 x 400 "
                "Gb/s ConnectX-7 InfiniBand NDR, one a GPU, between nodes; "
                "not measured")


@dataclasses.dataclass
class Step:
    """A cell's step, ready to trace: ``run()`` runs it once."""

    run: object
    args: object  # every tensor the step is handed (argument bytes)
    meta: dict


def build_step(arch: str, shape_name: str, *, reduced: bool = False,
               batch: int | None = None, seq: int | None = None,
               microbatches: int | None = None,
               serve_dtype: str | None = None,
               param_dtype: str | None = None, kernel: str = "cuda",
               device="meta", num_layers: int | None = None,
               attn_every: int | None = None,
               cache_len: int | None = None, grid=None) -> Step:
    """The counterpart of the JAX package's ``build_lowerable``: the step
    of one cell — the published or reduced config, the shape with
    ``batch`` / ``seq`` put in where given, cut to ``num_layers`` where
    given (a hybrid's shared block every ``attn_every`` layers where
    given) — on ``device`` (``"meta"``: nothing computed), with every input
    made, as ``launch/train.py`` and ``launch/serve.py`` make it.  A
    prefill fills a cache of ``cache_len`` positions, a decode step reads
    one and writes its last (default: the shape's sequence length).

    ``grid`` (a ``dist.sharding`` grid: a ``TracedGrid``, or a
    ``RankGrid``) builds one rank's step: the model's blocks on it, the
    global batch cut to the rank's rows, under ``activation_sharding``;
    the step's arguments are the rank's.  Under ``"fsdp"`` the embedding
    is the one-hot product (``iota_embed``), as the JAX dry run sets it."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    if attn_every:
        cfg = cfg.replace(attn_every=attn_every)
    shape = SHAPES[shape_name]
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq:
        shape = dataclasses.replace(shape, seq_len=seq)
    if param_dtype:
        cfg = cfg.replace(param_dtype=param_dtype)
    if serve_dtype and shape.kind in ("prefill", "decode"):
        cfg = cfg.replace(param_dtype=serve_dtype)
    if grid is not None and grid.strategy == "fsdp":
        cfg = cfg.replace(iota_embed=True)
    dev = torch.device(device)
    model = Model(cfg, kernel=kernel, device=dev, mesh=grid)
    b = shape.global_batch

    def rows(tree, microbatches=1):
        """The rank's rows of a global batch, in storages of their own (a
        rank holds no more)."""
        return tree if grid is None else {
            k: grid.local_rows(v, microbatches=microbatches).clone()
            for k, v in tree.items()}

    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "reduced": reduced, "batch": shape.global_batch,
            "seq": shape.seq_len, "kernel": kernel,
            "compute_dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "serve_dtype": serve_dtype, "num_layers": cfg.num_layers,
            "num_params": cfg.num_params(),
            "num_active_params": cfg.num_active_params()}

    def on_device(tree):
        return {k: on_device(v) if isinstance(v, dict) else (
            v if dev.type == "meta" else torch.zeros_like(v, device=dev))
            for k, v in tree.items()}

    if grid is not None:
        meta.update(world=grid.size, grid=dict(grid.shape),
                    strategy=grid.strategy, rank=grid.rank)
    if shape.kind == "train":
        mb = microbatches or choose_microbatches(
            cfg, shape, data_shards=1 if grid is None else grid.row_size)
        meta["microbatches"] = mb
        opt = AdamW(AdamWConfig(
            state_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32"))
        state = opt.init(model)
        data = on_device(batch_specs(cfg, shape, with_labels=True).args)
        step = make_train_step(model, opt, microbatches=mb)
        return Step(lambda: step(state, data),
                    (list(model.parameters()), state, rows(data, mb)), meta)

    meta["microbatches"] = 1
    model.served()  # the compute-dtype copies, made once before serving
    served = list(model.served().parameters())
    if shape.kind == "prefill":
        data = rows(on_device(batch_specs(cfg, shape,
                                          with_labels=False).args))
        prefill = make_prefill_step(model,
                                    cache_len=cache_len or shape.seq_len)

        def run_prefill():
            with torch.no_grad(), scope_of(grid, b):
                return prefill(data)

        return Step(run_prefill, (list(model.parameters()), served, data),
                    meta)
    cache_len = cache_len or shape.seq_len
    cache, _ = model.init_cache(b, cache_len)
    token = rows({"t": torch.zeros((b, 1), dtype=torch.int32,
                                   device=dev)})["t"]
    pos = cache_len - 1  # the cost of a step does not depend on it
    decode = make_decode_step(model)

    def run_decode():
        with torch.no_grad(), scope_of(grid, b):
            nxt, new_cache, _ = decode(cache, token, pos)
            return nxt, new_cache

    return Step(run_decode, (list(model.parameters()), served, cache, token),
                meta)


def scope_of(grid, batch: int):
    """``activation_sharding`` of ``grid`` for a global batch of ``batch``
    rows (nothing off a grid)."""
    if grid is None:
        return contextlib.nullcontext()
    return shd.activation_sharding(grid, grid.rules, batch=batch)


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (dicts, lists, tuples
    of tensors)."""
    seen = {}
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def card() -> dict:
    """The card the record is sized against: its name, ``nvidia-smi``'s
    name and power limit, and its memory; nulls without a card."""
    if not torch.cuda.is_available():
        return {"name": None, "nvidia_smi": None, "total_memory": None}
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": card_line("cuda"),
            "total_memory": torch.cuda.get_device_properties(0).total_memory}


def apply_stats(record: dict, stats: op_analysis.OpStats) -> dict:
    """Writes what a trace adds up to into ``record`` (``ops``, the
    trace's memory terms, ``fits`` and ``roofline``); ``run_cell`` and
    ``reanalyze`` share it."""
    record["ops"] = {
        "dot_flops_per_device": stats.dot_flops,
        "conv_flops_per_device": stats.conv_flops,
        "dot_bytes_per_device": stats.dot_bytes,
        "bytes_accessed_per_device": stats.bytes_accessed,
        "collective_wire_bytes_per_device": stats.collective_bytes,
        "collective_by_kind": stats.collective_by_kind,
        "collective_by_axis": stats.collective_by_axis,
        "collective_sites": stats.collective_count,
        "kernel_launches": stats.kernel_launches,
        "kernel_dot_flops": stats.kernel_dot_flops,
        "kernel_recompute_dot_flops": stats.kernel_recompute_dot_flops,
        "op_count": stats.op_count,
        "loop_trips": stats.loop_trips,
    }
    mem = record["memory"]
    mem["temp_bytes"] = stats.peak_bytes
    mem["output_bytes"] = stats.end_bytes
    mem["peak_estimate_bytes"] = mem["argument_bytes"] + stats.peak_bytes
    total = record["device"]["total_memory"]
    record["fits"] = (None if total is None
                      else mem["peak_estimate_bytes"] <= total)
    record["roofline"] = roofline_terms(record)
    return record


def traced_grid(mesh: str, strategy: str = "2d"):
    """Rank 0 of the grid the mesh tag names (``GRIDS``), None for
    ``h100x1``."""
    if mesh == MESH:
        return None
    return shd.TracedGrid(GRIDS[mesh], strategy=strategy)


def run_cell(arch: str, shape_name: str, *, reduced: bool = False,
             batch: int | None = None, seq: int | None = None,
             microbatches: int | None = None,
             out_dir: str | None = None, serve_dtype: str | None = None,
             param_dtype: str | None = None, tag: str = "",
             mesh: str = MESH, strategy: str = "2d") -> dict:
    t0 = time.perf_counter()
    grid = traced_grid(mesh, strategy)
    step = build_step(arch, shape_name, reduced=reduced, batch=batch,
                      seq=seq, microbatches=microbatches,
                      serve_dtype=serve_dtype, param_dtype=param_dtype,
                      grid=grid)
    world = 1 if grid is None else grid.size
    with op_analysis.OpCounter() as counter:
        out = step.run()
    trace_s = time.perf_counter() - t0
    del out
    record = dict(step.meta)
    record.update({"mesh": mesh, "world": world, "trace_s": trace_s,
                   "device": card(),
                   "memory": {"argument_bytes": tensor_bytes(step.args)}})
    if grid is not None:
        record["links"] = {ax: grid.link(None if ax == "grid" else ax)
                           for ax in ("model", "data", "grid")}
        record["link_rates"] = {**LINK_RATES, "source": RATES_SOURCE}
    apply_stats(record, counter.stats(world=world))
    if out_dir is None:
        out_dir = os.path.abspath(RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh}"
    if grid is not None and strategy != "2d":
        stem += f"__{strategy}"
    if reduced:
        stem += "__reduced"
    if tag:
        stem += f"__{tag}"
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    op_analysis.save_trace(os.path.join(out_dir, stem + ".ops.json.gz"),
                           counter.trace)
    return record


def roofline_terms(record: dict) -> dict:
    """Three per-step roofline terms in seconds on one card."""
    ops = record["ops"]
    mem = record["memory"]
    peak = PEAK_FLOPS[record["compute_dtype"]]
    # HBM term, as the JAX package's: the largest of the bytes every op
    # accesses (cost_analysis' "bytes accessed"), the dot traffic and the
    # step's arguments read and outputs written
    bytes_dev = max(float(ops["bytes_accessed_per_device"]),
                    float(ops["dot_bytes_per_device"]),
                    float(mem["argument_bytes"]) + float(mem["output_bytes"]))
    compute_s = (ops["dot_flops_per_device"]
                 + ops["conv_flops_per_device"]) / peak
    memory_s = bytes_dev / HBM_BW
    # the collectives: each grid axis's wire bytes over its link's rate
    links = record.get("links", {})
    by_axis = ops.get("collective_by_axis") or {
        "world": ops["collective_wire_bytes_per_device"]}
    collective_s = sum(b / LINK_RATES[links.get(ax, "nvlink")]
                       for ax, b in by_axis.items())
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "peak_flops": peak,
            "collective_s_by_axis": {
                ax: b / LINK_RATES[links.get(ax, "nvlink")]
                for ax, b in by_axis.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch × its shape cells")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced same-family configs")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--serve-dtype", default=None, choices=(None, "bfloat16"))
    ap.add_argument("--param-dtype", default=None, choices=(None, "bfloat16"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of the 2x16x16 (pod, data, model) grid, "
                         "512 ranks")
    ap.add_argument("--single-pod", action="store_true",
                    help="rank 0 of the 16x16 (data, model) grid, 256 "
                         "ranks")
    ap.add_argument("--strategy", default="2d",
                    choices=("2d", "fsdp", "serve"),
                    help="the grid's rule table (other than 2d alone: the "
                         "16x16 grid)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        mesh = "h100_2x16x16"
    elif args.single_pod or args.strategy != "2d":
        mesh = "h100_16x16"
    else:
        mesh = MESH

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in shape_cells(a)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    t_all = time.perf_counter()
    failures = []
    fits = 0
    for arch, shape in cells:
        label = f"{arch} × {shape} × {mesh}"
        if mesh != MESH:
            label += f" × {args.strategy}"
        try:
            rec = run_cell(arch, shape, reduced=args.reduced,
                           batch=args.batch, seq=args.seq,
                           microbatches=args.microbatches,
                           out_dir=args.out_dir,
                           serve_dtype=args.serve_dtype,
                           param_dtype=args.param_dtype, tag=args.tag,
                           mesh=mesh, strategy=args.strategy)
            fits += bool(rec["fits"])
            r, o = rec["roofline"], rec["ops"]
            print(f"OK   {label}: trace={rec['trace_s']:.1f}s "
                  f"flops={o['dot_flops_per_device']:.4g} "
                  f"peak={rec['memory']['peak_estimate_bytes'] / 2**30:.2f}"
                  f"GiB fits={rec['fits']} launches={o['kernel_launches']} "
                  f"compute={r['compute_s'] * 1e3:.2f}ms "
                  f"mem={r['memory_s'] * 1e3:.2f}ms "
                  f"coll={r['collective_s'] * 1e3:.2f}ms "
                  f"dom={r['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures.append((label, repr(e)))
            print(f"FAIL {label}: {e}", flush=True)
            traceback.print_exc()
    dev = card()
    print(f"{len(cells) - len(failures)} of {len(cells)} cells in "
          f"{time.perf_counter() - t_all:.1f}s on {mesh}; {fits} fit one "
          f"card a rank; sized against "
          f"{dev['nvidia_smi'] or 'no card'} "
          f"({dev['total_memory']} bytes)", flush=True)
    if failures:
        for label, err in failures:
            print(" ", label, err)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
