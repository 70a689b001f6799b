"""``repro_torch.launch.op_analysis`` — the port's counterpart of
``repro.launch.hlo_analysis`` — on the CPU and the meta device: dot FLOPs
and bytes of known shapes, the ring wire formulas against the JAX
package's, live bytes and their peak over a known allocation sequence, the
microbatch loop's sampling against a full trace, a saved trace re-analysed,
the bytes every op accesses, and the kernels' planned launches counted at
their plain versions' dot FLOPs and their own bytes."""
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis
from repro_torch.kernels import accounting
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.op_analysis import OpCounter

R = op_analysis.ALLOC_ROUND


def _stats(fn, device="meta"):
    with OpCounter(device=device) as c:
        out = fn()
    del out
    return c.stats()


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name, make, flops, nbytes", [
    ("mm", lambda d: torch.mm(torch.zeros(3, 5, device=d),
                              torch.zeros(5, 7, device=d)),
     2 * 3 * 7 * 5, 4 * (15 + 35 + 21)),
    ("addmm", lambda d: torch.addmm(torch.zeros(7, device=d),
                                    torch.zeros(3, 5, device=d),
                                    torch.zeros(5, 7, device=d)),
     2 * 3 * 7 * 5, 4 * (15 + 35 + 21)),
    ("bmm", lambda d: torch.bmm(torch.zeros(4, 3, 5, device=d),
                                torch.zeros(4, 5, 7, device=d)),
     2 * 4 * 3 * 7 * 5, 4 * 4 * (15 + 35 + 21)),
    ("einsum", lambda d: torch.einsum(
        "bhqd,bhkd->bhqk", torch.zeros(2, 3, 8, 16, device=d),
        torch.zeros(2, 3, 8, 16, device=d)),
     2 * 2 * 3 * 8 * 8 * 16, 4 * 6 * (128 + 128 + 64)),
    ("linear", lambda d: torch.nn.functional.linear(
        torch.zeros(2, 6, 5, device=d, dtype=torch.bfloat16),
        torch.zeros(7, 5, device=d, dtype=torch.bfloat16)),
     2 * 12 * 7 * 5, 2 * (60 + 35 + 84)),
])
def test_dot_flops_and_bytes_of_known_shapes(device, name, make, flops,
                                             nbytes):
    """2 × |out| × |contraction| FLOPs and operands + result bytes, as
    ``hlo_analysis`` counts a dot, whatever aten op carries it."""
    st = _stats(lambda: make(device), device=device)
    assert st.dot_flops == flops, name
    assert st.dot_bytes == nbytes, name
    assert st.conv_flops == 0 and st.kernel_launches == {}


def test_elementwise_work_counts_no_flops():
    x = torch.zeros(64, 64, device="meta")
    st = _stats(lambda: torch.softmax(x * 2 + 1, dim=-1))
    assert st.dot_flops == 0 and st.op_count == 3


def test_convolution_is_kept_apart():
    x = torch.zeros(2, 4, 16, device="meta")
    w = torch.zeros(6, 2, 3, device="meta")  # groups=2: 2 input channels
    st = _stats(lambda: torch.nn.functional.conv1d(x, w, groups=2))
    assert st.dot_flops == 0
    assert st.conv_flops == 2 * (2 * 6 * 14) * (2 * 3)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute", "send"])
def test_wire_formulas_equal_hlo_analysis(kind, g):
    for nbytes in (0, 4, 1 << 20, 12_345):
        assert op_analysis.wire_bytes(kind, nbytes, g) == \
            hlo_analysis._wire_bytes(kind, nbytes, g)


def test_collective_events_take_their_group_or_the_world():
    trace = [["collective", "all-reduce", 1024, None, 2048, 1],
             ["collective", "all-gather", 4096, 4, 5120, 2]]
    st = op_analysis.analyze(trace, world=8)
    ar = hlo_analysis._wire_bytes("all-reduce", 1024, 8)
    ag = 2 * hlo_analysis._wire_bytes("all-gather", 4096, 4)
    assert st.collective_by_kind == {"all-reduce": ar, "all-gather": ag}
    assert st.collective_bytes == ar + ag and st.collective_count == 3
    assert st.bytes_accessed == 2048 + 2 * 5120
    assert op_analysis.analyze(trace, world=1).collective_bytes == ag


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_of_a_known_allocation_sequence(device):
    """Live bytes rounded to the allocator's 512-byte blocks; a storage the
    trace was handed and frees counts negatively; views and in-place ops
    allocate nothing."""
    handed = [torch.zeros(1000, device=device)]  # 4000 B, rounded 4096

    def step():
        a = torch.empty(300, device=device)          # 1200 → 1536
        b = torch.empty(1000, device=device)         # 4000 → 4096
        a.add_(1).view(10, 30)                       # nothing new
        del a                                        # 1536 freed
        c = torch.empty(10, device=device)           # 40 → 512
        handed.pop()                                 # the handed 4096 freed
        return b, c

    with OpCounter(device=device) as counter:
        handed[0].mul_(2)  # seen as handed
        out = step()
    st = counter.stats()
    assert st.peak_bytes == 1536 + 4096
    assert st.end_bytes == 4096 + 512 - 4096
    del out


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_softmax_backward_counts_the_cards_temporary(device):
    """``_softmax_backward_data``'s CUDA kernel holds a temporary of its
    output's size while it runs: the peak is the live inputs plus twice
    the gradient."""
    x = torch.zeros(8, 1000, device=device, requires_grad=True)  # 32000 B
    g = torch.zeros(8, 1000, device=device)

    def step():
        y = torch.softmax(x, dim=-1)
        return torch.autograd.grad(y, x, g)

    st = _stats(step, device=device)
    blk = 32256  # 32000 rounded to 512
    assert st.peak_bytes == blk + 2 * blk  # y, grad_input, the temporary
    assert st.end_bytes == blk


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_scalar_constants_are_not_counted(device):
    """A 0-d constant ``torch.tensor`` makes (on the card a host scalar, or
    one block) does not count; on the CPU a larger one, lifted into the
    trace, counts from its creation."""
    x = torch.zeros(4, device=device)
    st = _stats(lambda: torch.tensor(0.9, device=device) + x, device=device)
    assert st.peak_bytes == R and st.end_bytes == R
    if device == "cpu":
        st = _stats(lambda: torch.tensor([0.5] * 200) + 1, device=device)
        assert st.peak_bytes == 2 * 1024 and st.end_bytes == 1024


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-2.7b"])
@pytest.mark.parametrize("mb", [2, 4])
def test_sampled_microbatch_loop_equals_the_full_trace(arch, mb,
                                                      monkeypatch):
    """The train step's microbatch loop as a meta trace samples it through
    ``accounting.trips`` (the first iteration, and the second weighing
    ``mb - 1``) counts what the whole loop does — the loop run in full,
    ``trips`` put back to ``range`` —: dot FLOPs and bytes, bytes
    accessed, launches, ops and the peak."""
    def trace():
        step = dryrun.build_step(arch, "train_4k", reduced=True, batch=4,
                                 seq=64, microbatches=mb)
        return _stats(step.run)

    sampled = trace()
    monkeypatch.setattr(accounting, "trips", range)
    full = trace()
    for key in ("dot_flops", "dot_bytes", "bytes_accessed",
                "kernel_launches", "op_count", "peak_bytes",
                "kernel_dot_flops", "kernel_recompute_dot_flops"):
        assert getattr(sampled, key) == getattr(full, key), key
    assert sampled.loop_trips == ([mb] if mb > 2 else [])
    assert full.loop_trips == []


def test_a_saved_trace_reanalyses_to_the_live_counter(tmp_path):
    step = dryrun.build_step("zamba2-2.7b", "train_4k", reduced=True,
                             batch=4, seq=64, microbatches=4)
    with OpCounter() as c:
        out = step.run()
    del out
    live = c.stats(world=1)
    path = tmp_path / "t.ops.json.gz"
    op_analysis.save_trace(path, c.trace)
    assert op_analysis.analyze(op_analysis.load_trace(path), world=1) == live
    assert live.kernel_launches == {"flash_attention": 16, "ssd_chunk": 32}


def test_planned_launches_count_the_plain_versions_dots():
    """On meta tensors the kernel wrappers plan their launch: outputs of
    the documented shapes, one launch reported at the plain version's dot
    FLOPs and at the kernel's own bytes — inputs read and outputs written
    once, far below the plain version's scores —, the library neither
    built nor counted."""
    rng = np.random.default_rng(0)
    q = torch.zeros(2, 8, 96, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 96, 64, device="meta", dtype=torch.bfloat16)
    launches = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    with OpCounter() as c:
        o = fa.flash_attention(q, kv, kv, causal=True)
    assert o.shape == q.shape and o.device.type == "meta"
    want = _stats(lambda: fa.flash_attention_plain(q, kv, kv, causal=True))
    st = c.stats()
    assert st.kernel_launches == {"flash_attention": 1}
    assert st.dot_flops == want.dot_flops == 4 * 2 * 8 * 96 * 96 * 64
    io = 2 * (2 * 8 * 96 * 64) * 2 + 2 * 2 * (2 * 2 * 96 * 64)  # q, o; k, v
    assert st.dot_bytes == st.bytes_accessed == io < want.dot_bytes
    assert st.kernel_dot_flops == st.dot_flops
    b, nc, l, h, p, g, n = 1, 3, 16, 4, 16, 2, 8
    args = [torch.zeros(s, device="meta") for s in (
        (b, nc, l, h, p), (b, nc, l, h), (h,), (b, nc, l, g, n),
        (b, nc, l, g, n))]
    with OpCounter() as c:
        y, state, decay, gate = ssd.ssd_chunk(*args)
    assert [tuple(t.shape) for t in (y, state, decay, gate)] == [
        (b, nc, l, h, p), (b, nc, h, n, p), (b, nc, h), (b, nc, l, h)]
    want = _stats(lambda: ssd.ssd_chunk_plain(*args))
    assert c.stats().dot_flops == want.dot_flops > 0
    io = 4 * sum(t.numel() for t in (*args, y, state, decay, gate))
    assert c.stats().dot_bytes == c.stats().bytes_accessed == io
    assert c.stats().kernel_launches == {"ssd_chunk": 1}
    assert (fa.flash_attention.launches, ssd.ssd_chunk.launches) == launches
    del rng


def test_no_counter_no_cost():
    """Without an active counter a planned launch reports nothing and the
    loop marker is ``range``; under a counter on real tensors it stays
    ``range``, and only meta counters sample."""
    q = torch.zeros(1, 2, 16, 16, device="meta")
    fa.flash_attention(q, q, q)
    assert list(accounting.trips(5)) == [0, 1, 2, 3, 4]
    with OpCounter(device="cpu"):
        assert list(accounting.trips(5)) == [0, 1, 2, 3, 4]
        with OpCounter():  # a meta counter inside a CPU one
            assert list(accounting.trips(5)) == [0, 1, 2, 3, 4]
    with OpCounter():
        assert list(accounting.trips(5)) == [0, 1]
        assert list(accounting.trips(2)) == [0, 1]


def test_a_counter_on_real_tensors_leaves_the_train_step_as_it_is():
    """A CPU counter around a train step of four microbatches: the step
    runs every microbatch, so its parameters equal an uncounted step's bit
    for bit."""
    def trained(counted: bool):
        step = dryrun.build_step("stablelm-1.6b", "train_4k", reduced=True,
                                 batch=4, seq=16, microbatches=4,
                                 kernel="reference", device="cpu")
        torch.manual_seed(0)
        for p in step.args[0]:
            p.data.copy_(0.02 * torch.randn(p.shape))
        toks = torch.randint(0, 100, step.args[2]["tokens"].shape,
                             dtype=torch.int32)
        step.args[2]["tokens"].copy_(toks)
        step.args[2]["labels"].copy_(toks)
        if counted:
            with OpCounter(device="cpu") as c:
                step.run()
            assert c.stats().loop_trips == []
        else:
            step.run()
        return [p.detach().clone() for p in step.args[0]]

    for a, b in zip(trained(True), trained(False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_bytes_accessed_of_known_ops(device):
    """Each op's arguments read and outputs written on the counter's
    device; views and ``empty`` move nothing, ``fill_`` only writes, an
    argument broadcast by a 0 stride is read at its storage's size."""
    x = torch.zeros(64, 32, device=device)  # 8192 B
    row = torch.zeros(32, device=device)    # 128 B

    def acc(fn):
        return _stats(fn, device=device).bytes_accessed

    assert acc(lambda: x.view(32, 64).t()) == 0
    assert acc(lambda: torch.empty(64, 32, device=device)) == 0
    assert acc(lambda: x * 2) == 2 * 8192
    assert acc(lambda: x + row) == 8192 + 128 + 8192
    assert acc(lambda: x.fill_(1.0)) == 8192
    assert acc(lambda: x.add_(x)) == 3 * 8192
    assert acc(lambda: row.expand(64, 32).clone()) == 128 + 8192
    assert acc(lambda: x @ x.t()) == 8192 * 2 + 64 * 64 * 4
