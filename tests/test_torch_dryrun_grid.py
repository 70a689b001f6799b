"""The dry run's account of a grid of ranks on the CPU: ``launch.dryrun``'s
``build_step(grid=dist.sharding.TracedGrid(...))`` traced on the meta
device, against the JAX package's dry run of the same reduced cells on an
8-device (4, 2) host mesh with Auto axes under ``make_rules``
(tests/jax_mesh_oracle.py's ``hlo`` mode: ``hlo_analysis.analyze`` of the
compiled step and ``memory_analysis``), and against a real gloo (2, 2)
world.

Held: a rank's dot FLOPs (less ``kernel_recompute_dot_flops``, the plain
forwards a kernel's backward recomputes) within 2% of JAX's per-device
dot FLOPs, train and decode, for reduced stablelm-1.6b, qwen2-72b,
zamba2-2.7b, mamba2-1.3b, whisper-base and qwen3-moe (B = 32 rows of 32
tokens); a rank's argument bytes within 5% of JAX's (a decode step's
without the compute-dtype copies the port keeps, which JAX makes inside
its step, and whisper's decode without the encoder's parameters, which
JAX prunes from a step that never reads them); each rank of a real gloo
(2, 2) world (``RankGrid``, the reference kernels, on the CPU) traces
the same dots and collectives (kind, bytes, group, axis) as the traced
grid's rank of the same coordinates; reduced stablelm's decode
collectives on the traced (4, 2) grid against a count of its layout
written out below; and each cell's collectives by kind and axis against
JAX's HLO on the mesh, in float32 compute (the decode steps within 1% of
JAX's total, kind by kind, the SSM archs' re-lay an all-gather bounded
by 1.6× JAX's gathers; the train steps within the bands that XLA's
partitioner's other choices leave, set out in
``test_grid_train_collectives_by_kind_against_jax``).
"""
import concurrent.futures

import pytest

import torch_model_ranks as W
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.op_analysis import OpCounter, wire_bytes
from test_torch_ranks_moe import _collect, _oracle

GRID_SHAPE = (4, 2)
GRID_B, GRID_S = 32, 32
SHAPE_OF = {"train": "train_4k", "decode": "decode_32k"}
ARCHS = ("stablelm-1.6b", "qwen2-72b", "zamba2-2.7b", "mamba2-1.3b",
         "whisper-base", "qwen3-moe-235b-a22b")
CELLS = [f"{a}:{k}" for a in ARCHS for k in SHAPE_OF]
# the collectives are compared in float32 compute: XLA's CPU backend
# computes bf16 in float32 and moves float32 wires (gathers of the float32
# parameters before their cast among them) where the port moves bf16
F32_CELLS = [f"{c}:float32" for c in CELLS]
# JAX's group sizes on the (4, 2) mesh → the port's axis names
AXIS_OF_GROUP = {4: "data", 2: "model", 8: "grid"}
SSM_ARCHS = ("zamba2-2.7b", "mamba2-1.3b")
GATHERS = ("all-gather", "all-to-all", "collective-permute")
REDUCTIONS = ("all-reduce", "reduce-scatter")
FLOPS_RTOL = 0.02
ARGS_RTOL = 0.05
# the real world's cells: (arch, shape) on (2, 2), B rows of S tokens
WORLD_CELLS = (("stablelm-1.6b", "train_4k"), ("zamba2-2.7b", "train_4k"),
               ("qwen3-moe-235b-a22b", "decode_32k"))
WORLD_B, WORLD_S = 8, 16
WORLD_TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_grid")
    proc = _oracle("hlo", tmp / "hlo.pkl", *CELLS, *F32_CELLS)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            world = ex.submit(spawn_ranks, W.grid_trace_world, 4,
                              (2, WORLD_CELLS, WORLD_B, WORLD_S),
                              backend="gloo",
                              init_method=f"file://{tmp}/world",
                              timeout_s=WORLD_TIMEOUT_S)
            port = {cell: _traced(*cell.split(":")) for cell in CELLS}
            port.update({cell: _traced_collectives(*cell.split(":"))
                         for cell in F32_CELLS})
            ranks = world.result()
        want = _collect(proc, tmp / "hlo.pkl", WORLD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return port, want, ranks


def _traced(arch, kind):
    grid = shd.TracedGrid(dict(zip(("data", "model"), GRID_SHAPE)))
    step = dryrun.build_step(arch, SHAPE_OF[kind], reduced=True,
                             batch=GRID_B, seq=GRID_S, grid=grid)
    with OpCounter() as counter:
        out = step.run()
    del out
    st = counter.stats()
    params, *rest = step.args
    if kind == "decode":  # the compute-dtype copies the port keeps
        rest = rest[1:]
        if arch == "whisper-base":
            names = [n for n, _ in step_model_names(step)]
            params = [p for n, p in zip(names, params)
                      if not n.startswith(("encoder.", "enc_"))]
    return {"dot_flops": st.dot_flops - st.kernel_recompute_dot_flops,
            "argument_bytes": dryrun.tensor_bytes((params, *rest)),
            "collective_by_kind": st.collective_by_kind}


def _traced_collectives(arch, kind, dtype):
    """Rank 0's collectives on the traced (4, 2) grid with the reduced
    config's compute dtype set to ``dtype``: ``(kind, axis)`` → wire
    bytes."""
    grid = shd.TracedGrid(dict(zip(("data", "model"), GRID_SHAPE)))
    with pytest.MonkeyPatch.context() as mp:
        get = dryrun.get_reduced
        mp.setattr(dryrun, "get_reduced",
                   lambda a: get(a).replace(dtype=dtype))
        step = dryrun.build_step(arch, SHAPE_OF[kind], reduced=True,
                                 batch=GRID_B, seq=GRID_S, grid=grid)
    with OpCounter() as counter:
        step.run()
    out: dict = {}
    for ev in counter.trace:
        if ev[0] == "collective":
            _, ckind, result, g, _, w, *axis = ev
            key = (ckind, axis[0] if axis else "world")
            out[key] = out.get(key, 0.0) + wire_bytes(ckind, result, g) * w
    return {"collectives": out}


def _collectives(port, want, cell):
    """The port's and JAX's ``(kind, axis)`` → wire bytes of a float32
    cell."""
    got = port[f"{cell}:float32"]["collectives"]
    w = {(k, AXIS_OF_GROUP[g]): v for (k, g), v
         in want[f"{cell}:float32"]["collective_by_group"].items()}
    return got, w


def _family(c: dict, kinds, axes=None) -> float:
    return sum(v for (k, a), v in c.items()
               if k in kinds and (axes is None or a in axes))


def step_model_names(step):
    """The parameter names of a built step's model, in ``parameters()``
    order (the step's first argument)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model

    cfg = get_reduced(step.meta["arch"])
    return list(Model(cfg, device="meta").named_parameters())


@pytest.mark.parametrize("cell", CELLS)
def test_grid_dot_flops_within_two_percent_of_jax(runs, cell):
    port, want, _ = runs
    got, w = port[cell]["dot_flops"], want[cell]["dot_flops"]
    assert abs(got / w - 1) <= FLOPS_RTOL, (cell, got, w)


@pytest.mark.parametrize("cell", CELLS)
def test_grid_argument_bytes_within_five_percent_of_jax(runs, cell):
    port, want, _ = runs
    got, w = port[cell]["argument_bytes"], want[cell]["argument_bytes"]
    assert abs(got / w - 1) <= ARGS_RTOL, (cell, got, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_decode_collectives_by_kind_match_jax(runs, arch):
    """A decode step (a forward: the layout leaves the partitioner few
    choices) on the traced (4, 2) grid against JAX's HLO on the 8-device
    mesh, in float32: every kind's wire bytes over each axis within 1% of
    JAX's total.  Zamba2 and mamba2 re-lay the packed ``in_proj`` columns
    head-aligned as an all-gather over ``model`` where JAX's partitioner
    runs an all-to-all and a collective-permute: there the reductions are
    held so, and the port's gathers (all-gather, all-to-all,
    collective-permute, every axis) are at least JAX's and at most 1.6×
    them (1.31× for zamba2, whose shared block the port gathers over data
    at each of its 2 invocations and JAX once; 1.10× for mamba2)."""
    port, want, _ = runs
    got, w = _collectives(port, want, f"{arch}:decode")
    total = sum(w.values())
    assert set(k for k, _ in got) <= set(k for k, _ in w), (got, w)
    keys = set(got) | set(w)
    if arch in SSM_ARCHS:
        keys = {(k, a) for k, a in keys if k in REDUCTIONS}
        g, jg = _family(got, GATHERS), _family(w, GATHERS)
        assert jg <= g <= 1.6 * jg, (arch, g, jg)
    for key in keys:
        a, b = got.get(key, 0.0), w.get(key, 0.0)
        assert abs(a - b) <= 0.01 * total, (arch, key, a, b, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_train_collectives_by_kind_against_jax(runs, arch):
    """A train step on the traced (4, 2) grid against JAX's HLO on the
    8-device mesh, in float32.  Here XLA's partitioner chooses otherwise:
    its CPU backend reduces a sharded gradient with an all-reduce and a
    slice (twice a reduce-scatter's wire), it all-reduces the q, k and v
    inputs' gradients apart where the port sums them first, it gathers
    qwen3-moe's router logits over data, and it re-lays an SSM's packed
    columns with an all-to-all and a collective-permute.  Held: the port
    moves no kind JAX's partitioner does not (reduce-scatter apart); the
    FSDP gathers (all-gather over data) between 0.8× and 1.0× JAX's
    (equal for stablelm, qwen2, whisper and mamba2); the reductions
    (all-reduce, reduce-scatter, every axis) between 0.6× and 1.2× JAX's
    (0.65–1.15× on these cells); and the step's whole wire between 0.5×
    and 1.0× JAX's (0.63–0.76×)."""
    port, want, _ = runs
    got, w = _collectives(port, want, f"{arch}:train")
    kinds = set(k for k, _ in w) | {"reduce-scatter"}
    assert set(k for k, _ in got) <= kinds, (got, w)
    fsdp = (_family(got, ("all-gather",), ("data",)),
            _family(w, ("all-gather",), ("data",)))
    assert 0.8 * fsdp[1] <= fsdp[0] <= 1.0 * fsdp[1], (arch, fsdp)
    red = _family(got, REDUCTIONS), _family(w, REDUCTIONS)
    assert 0.6 * red[1] <= red[0] <= 1.2 * red[1], (arch, red)
    whole = sum(got.values()), sum(w.values())
    assert 0.5 * whole[1] <= whole[0] <= whole[1], (arch, whole)


@pytest.mark.parametrize("cell", WORLD_CELLS,
                         ids=[f"{a}-{s}" for a, s in WORLD_CELLS])
def test_gloo_world_traces_as_the_traced_grid(runs, cell):
    """Rank r of a real gloo (2, 2) world and rank r of the traced (2, 2)
    grid run the same dots, in order, and the same collectives (NCCL's
    kind, result bytes, group size, axis)."""
    _, _, ranks = runs
    arch, shape = cell
    for r in ranks:
        grid = shd.TracedGrid({"data": 2, "model": 2}, rank=r["rank"],
                              backend="gloo")
        step = dryrun.build_step(arch, shape, reduced=True, batch=WORLD_B,
                                 seq=WORLD_S, kernel="reference", grid=grid)
        with OpCounter() as counter:
            step.run()
        want = W.trace_summary(counter.trace)
        got = r["cells"][cell]
        assert got["dots"] == want["dots"], (cell, r["rank"])
        assert got["collectives"] == want["collectives"], (cell, r["rank"])
        assert want["collectives"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k"])
def test_ssm_groups_over_split_heads_raise(shape, monkeypatch):
    """Heads split over ``model`` with more than one SSM group: the
    forward, the prefill and a decode step each refuse the layout."""
    get = dryrun.get_reduced
    monkeypatch.setattr(dryrun, "get_reduced",
                        lambda a: get(a).replace(ssm_groups=2))
    grid = shd.TracedGrid({"data": 2, "model": 2})
    step = dryrun.build_step("mamba2-1.3b", shape, reduced=True, batch=4,
                             seq=32, grid=grid)
    with pytest.raises(ValueError, match="2 SSM groups"):
        step.run()


def test_stablelm_decode_collectives_by_hand():
    """Reduced stablelm-1.6b's decode step (B = 32, a cache of 32
    positions) on rank 0 of the traced (4, 2) grid, its collectives
    counted from the layout: d = 64, 4 q and 4 KV heads of 16 (2 a rank),
    d_ff 128 (64 a rank), vocabulary 256 (128 a rank), 2 layers, bf16
    weights in the served tree, 8 rows a rank; the cache by sequence (4 KV
    heads do not divide 16: 16 of the 32 positions a rank)."""
    grid = shd.TracedGrid({"data": 4, "model": 2})
    step = dryrun.build_step("stablelm-1.6b", "decode_32k", reduced=True,
                             batch=GRID_B, seq=GRID_S, grid=grid)
    with OpCounter() as counter:
        step.run()
    st = counter.stats()
    bf16, f32, i64 = 2, 4, 8
    rows, d, hd = 8, 64, 16
    data = model = 0.0

    def gather_data(nbytes):  # an FSDP gather over the 4 data ranks
        return wire_bytes("all-gather", nbytes, 4)

    def reduce_model(nbytes):  # an all-reduce over the 2 model ranks
        return wire_bytes("all-reduce", nbytes, 2)

    def gather_model(nbytes):
        return wire_bytes("all-gather", nbytes, 2)

    model += reduce_model(rows * d * bf16)  # the vocab-parallel embedding
    for _ in range(2):  # layers
        # wq, wk, wv (FSDP, heads, None): (64, 2, 16) gathered over data;
        # wo (heads, None, FSDP): (2, 16, 64)
        data += 4 * gather_data(d * 2 * hd * bf16)
        # the new token's k and v: every KV head, for the rank that owns
        # its position; every q head for flash-decoding
        model += 3 * gather_model(rows * 4 * hd * bf16)
        # flash-decoding: the max and the sum (rows, 4 KV heads, 1, 1, 1)
        # in float32, the output (rows, 1, 4, 1, 16) in bf16
        model += 2 * reduce_model(rows * 4 * f32)
        model += reduce_model(rows * 4 * hd * bf16)
        model += reduce_model(rows * d * bf16)  # wo, row-parallel
        # the FFN: wi, wg (FSDP, TENSOR) (64, 64), wo (TENSOR, FSDP)
        data += 3 * gather_data(d * 64 * bf16)
        model += reduce_model(rows * d * bf16)  # wo, row-parallel
    # the argmax over the vocabulary's blocks: the rows' largest values
    # (the logits are in the compute dtype) and the smallest index
    # reaching them (int64)
    model += reduce_model(rows * bf16) + reduce_model(rows * i64)
    assert st.collective_by_axis == {"data": data, "model": model}
    assert st.collective_bytes == data + model
