"""Decode through ``serve.decode_graph.DecodeGraphs``, the closure that
``serve.engine.make_decode_fn`` returns.

On the CPU the closure is ``transformer.decode_step`` run eagerly.  With
``FakeCapture`` in place of the CUDA calls a "graph" is its step run
again at each replay, so the runner's bookkeeping and its write-back into
the state are held here against eager decode: one capture per new state,
replays on the same state, a fresh capture after a re-cut, a graph dropped
with its state, eager for a ``DTensor`` state or under a mesh, eager and
counted where a capture runs out of memory, launches counted once a step.
The ``cuda``-marked cases run the real
graphs against eager decode on the card (reduced falcon-mamba-7b and
deepseek-moe-16b)::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph.py
"""
import contextlib
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.parallel import shardctx  # noqa: E402
from repro_torch.serve import decode_graph as DG  # noqa: E402
from repro_torch.serve import state_utils as su  # noqa: E402
from repro_torch.serve.engine import make_decode_fn  # noqa: E402

# (arch, layers): recurrentgemma's 4 layers leave one ``rest`` layer
ARCHS = [("falcon-mamba-7b", None), ("deepseek-moe-16b", None),
         ("recurrentgemma-9b", 4)]


class FakeGraph:
    def __init__(self, fn, keep):
        self.fn = fn
        self.keep = keep

    def replay(self):
        if self.fn is not None:
            self.fn()
        if not self.keep:
            self.fn = None


class FakeCudaGraph:
    """``torch.cuda.CUDAGraph`` as ``CudaCapture.capture`` drives it, with
    an end of capture that fails where ``end_fails`` says (as a capture
    the step left invalid does)."""

    def __init__(self, end_fails):
        self.end_fails = end_fails
        self.calls = []

    def capture_begin(self, pool=None):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")
        if self.end_fails:
            raise RuntimeError("fake: capture invalidated")


class FakeCapture(DG.CudaCapture):
    """The CUDA calls as the CPU can make them: a capture keeps its step
    and runs nothing, a replay runs the step.  The step holds its state, as
    a real graph does not; with ``keep=False`` a graph forgets its step
    after its first replay, so that the state can go.  With ``oom`` set a
    capture goes through ``CudaCapture.capture`` on a ``FakeCudaGraph``
    with a step that runs out of memory."""

    def __init__(self, keep=True):
        self.oom = None           # None, or whether ending the capture fails
        self.keep = keep
        self.graphs = []          # weakrefs to every graph made, the
        #                           pool's anchor first
        self.ended = []           # each failed capture's FakeCudaGraph

    def owns(self, t):
        return True

    def stream(self, device):
        return None

    def pool(self, device):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def capture(self, fn, stream, pool):
        if self.oom is not None:
            def oom():
                raise torch.cuda.OutOfMemoryError("fake")
            graph = FakeCudaGraph(self.oom)
            self.ended.append(graph)
            with pytest.MonkeyPatch.context() as m:
                m.setattr(torch.cuda, "CUDAGraph", lambda: graph)
                return super().capture(oom, stream, pool)
        g = FakeGraph(fn, self.keep)
        self.graphs.append(weakref.ref(g))
        return g


def _model(arch, layers=None, dtype="float32", device="cpu"):
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, T.init_model(cfg, gen, device=device)


def _prefill(cfg, params, rt, batch, seed=0, seq=8):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    dev = params["embed"]["table"].device
    with torch.no_grad():
        logits, st = T.prefill(params, {"tokens": toks.to(dev)}, cfg, rt,
                               window=seq + 16)
    return logits.argmax(-1)[:, None], st


def _clone(state):
    return pytree.map_(torch.clone, state)


def _ptrs(state):
    return [x.data_ptr() for x in pytree.leaves(state)]


def _assert_states_equal(a, b):
    for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
        assert torch.equal(x, y)


@pytest.fixture(autouse=True)
def _log_off():
    spans.stop()
    spans.take()
    yield
    spans.stop()
    spans.take()


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_cpu_decode_is_eager_decode_step(arch, layers):
    cfg, params = _model(arch, layers)
    rt = T.Runtime()
    decode = make_decode_fn(cfg, rt)
    assert isinstance(decode, DG.DecodeGraphs)
    tok, st = _prefill(cfg, params, rt, 3)
    ref, ref_tok = _clone(st), tok.clone()
    with torch.no_grad():
        for _ in range(4):
            logits, new = decode(params, st, tok)
            want, ref = T.decode_step(params, ref, ref_tok, cfg, rt)
            assert new is not st         # decode_step's own new state
            assert torch.equal(logits, want)
            _assert_states_equal(new, ref)
            st, tok = new, logits.argmax(-1)[:, None]
            ref_tok = want.argmax(-1)[:, None]
    assert (decode.captures, decode.replays, decode.eager, decode.live) == \
        (0, 0, 0, 0)


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_graph_steps_write_back_and_equal_eager(arch, layers):
    """One capture, then replays; the state that comes back is the one
    that went in, leaf for leaf, and holds what eager decode computes."""
    cfg, params = _model(arch, layers)
    rt = T.Runtime()
    decode = DG.DecodeGraphs(cfg, rt, cuda=FakeCapture())
    tok, st = _prefill(cfg, params, rt, 3)
    ref, ref_tok = _clone(st), tok.clone()
    ptrs = _ptrs(st)
    held = []
    with torch.no_grad():
        for _ in range(5):
            logits, new = decode(params, st, tok)
            want, ref = T.decode_step(params, ref, ref_tok, cfg, rt)
            assert new is st and _ptrs(new) == ptrs
            assert torch.equal(logits, want)
            _assert_states_equal(st, ref)
            held.append((logits, want))
            tok = ref_tok = want.argmax(-1)[:, None]
    assert all(torch.equal(a, b) for a, b in held)
    assert (decode.captures, decode.replays, decode.eager, decode.live) == \
        (1, 5, 0, 1)


def test_recut_captures_afresh_and_equals_eager():
    """Two parts of one batch size, decoded in turns after a re-cut by
    ``take`` and re-fused by ``concat``: a capture per new state and the
    tokens eager decode gives."""
    cfg, params = _model("falcon-mamba-7b")
    rt = T.Runtime()
    decode = DG.DecodeGraphs(cfg, rt, cuda=FakeCapture())
    tok, st = _prefill(cfg, params, rt, 4)
    ref = _clone(st)

    def step(p):
        state, t, r = p
        logits, new = decode(params, state, t)
        want, p[2] = T.decode_step(params, r, t, cfg, rt)
        assert new is state and torch.equal(logits, want)
        _assert_states_equal(state, p[2])
        p[1] = want.argmax(-1)[:, None]

    with torch.no_grad():
        whole = [st, tok, ref]
        step(whole)
        parts = [[su.take(whole[0], ids), su.rows(whole[1], ids),
                  su.take(whole[2], ids)] for ids in ([0, 2], [1, 3])]
        for _ in range(3):
            for p in parts:
                step(p)
        assert (decode.captures, decode.replays) == (3, 7)
        merged = [su.concat([p[0] for p in parts]),
                  torch.cat([p[1] for p in parts]),
                  su.concat([p[2] for p in parts])]
        step(merged)
        step(merged)
    assert (decode.captures, decode.replays, decode.eager) == (4, 9, 0)


def test_graph_released_with_its_state():
    """A graph goes when its state does: a re-cut's ``take`` and
    ``concat`` drop the old states and so their graphs."""
    cfg, params = _model("falcon-mamba-7b")
    rt = T.Runtime()
    fake = FakeCapture(keep=False)
    decode = DG.DecodeGraphs(cfg, rt, cuda=fake)
    tok, st = _prefill(cfg, params, rt, 4)
    with torch.no_grad():
        decode(params, st, tok)
        decode(params, st, tok)
        assert (decode.captures, decode.replays, decode.live) == (1, 2, 1)
        parts = [su.take(st, ids) for ids in ([0, 2], [1, 3])]
        del st
        gc.collect()
        assert decode.live == 0 and fake.graphs[1]() is None
        for p in parts:
            decode(params, p, tok[:2])
        assert (decode.captures, decode.live) == (3, 2)
        merged = su.concat(parts)
        del parts, p
        gc.collect()
        assert decode.live == 0
        decode(params, merged, tok)
        assert (decode.captures, decode.live) == (4, 1)
    del merged
    gc.collect()
    assert decode.live == 0
    assert all(r() is None for r in fake.graphs[1:])
    assert fake.graphs[0]() is not None


@pytest.mark.parametrize("end_fails", [False, True])
def test_short_memory_runs_eager_and_counts(end_fails):
    """Where a capture runs out of memory, the capture is ended and the
    call runs eagerly, counted, and its ``group.decode`` span says so; an
    end of capture that fails after the step's error does not hide it."""
    cfg, params = _model("falcon-mamba-7b")
    rt = T.Runtime()
    fake = FakeCapture()
    decode = DG.DecodeGraphs(cfg, rt, cuda=fake)
    tok, st = _prefill(cfg, params, rt, 2)
    spans.start()
    with torch.no_grad():
        with spans.span("group.decode"):
            decode(params, st, tok)
        fake.oom = end_fails
        tok2, st2 = _prefill(cfg, params, rt, 2, seed=1)
        ref = _clone(st2)
        with spans.span("group.decode"):
            logits, new = decode(params, st2, tok2)
        want, _ = T.decode_step(params, ref, tok2, cfg, rt)
        assert torch.equal(logits, want) and new is not st2
    got = spans.take()["spans"]
    assert (decode.captures, decode.eager, decode.live) == (1, 1, 1)
    (ended,) = fake.ended
    assert ended.calls == ["begin", "end"]
    by_name = {}
    for s in got:
        by_name.setdefault(s["name"], []).append(s)
    decodes = by_name["group.decode"]
    assert [d["attrs"].get("eager") for d in decodes] == [None, 1]
    # a capture that ran out of memory still shows, in the eager call
    cap, *failed = by_name["model.decode_capture"]
    assert [f["parent"] for f in failed] == [decodes[1]["id"]]
    (rep,) = by_name["model.decode_replay"]
    assert cap["parent"] == rep["parent"] == decodes[0]["id"]
    assert cap["attrs"]["batch"] == rep["attrs"]["batch"] == 2
    assert cap["attrs"]["ms"] >= 0


def test_launches_counted_once_a_step(monkeypatch):
    """``ops.launches`` counts what each call's step launches once: not the
    pool's eager warm-up on a throwaway row, and not the capture's host
    pass, which runs nothing on the device."""
    cfg, params = _model("falcon-mamba-7b")
    rt = T.Runtime()
    inner = T.decode_step

    def counted(*a, **kw):
        ops.launches["rmsnorm"] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(T, "decode_step", counted)
    decode = DG.DecodeGraphs(cfg, rt, cuda=FakeCapture())
    tok, st = _prefill(cfg, params, rt, 2)
    ops.reset_launches()
    with torch.no_grad():
        for n in range(1, 4):
            decode(params, st, tok)
            assert ops.launches["rmsnorm"] == n
    assert (decode.captures, decode.replays) == (1, 3)


@pytest.fixture
def mesh1():
    """A one-rank ``fake`` process group and its mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("how", ["dtensor_state", "mesh"])
def test_dtensor_state_or_mesh_is_eager(mesh1, how, monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate
    cfg, params = _model("falcon-mamba-7b")
    rt = T.Runtime()
    decode = DG.DecodeGraphs(cfg, rt, cuda=FakeCapture())
    tok, st = _prefill(cfg, params, rt, 2)
    if how == "dtensor_state":
        st = st._replace(pos=DTensor.from_local(st.pos, mesh1, [Replicate()],
                                                run_check=False))
    calls = []
    monkeypatch.setattr(T, "decode_step",
                        lambda *a: calls.append(a) or ("eager", a[1]))
    with shardctx.use_mesh(mesh1) if how == "mesh" \
            else contextlib.nullcontext():
        assert decode(params, st, tok) == ("eager", st)
    assert len(calls) == 1
    assert (decode.captures, decode.eager, decode.live) == (0, 0, 0)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_tol(logits):
    """Path parity: max(0.1, 3e-2 x the largest logit)."""
    return max(0.1, 3e-2 * float(logits.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-moe-16b"])
def test_cuda_graphs_equal_eager_across_a_recut(cuda, arch, dtype):
    """Two parts of batch 3 decoded in turns through real graphs, re-cut
    in the middle (``take`` and ``concat``), against eager decode of the
    same rows: float32 tokens equal at every step, bf16 logits at the
    path tolerance; the state's leaves stay where they were; logits a
    caller holds survive the next call; ``ops.launches`` counts each
    call's kernels as eager decode does, the first call's too."""
    cfg, params = _model(arch, dtype=dtype, device=cuda)
    rt = T.Runtime(use_kernels=True)
    decode = make_decode_fn(cfg, rt)
    tok, st = _prefill(cfg, params, rt, 6)
    # [state, tokens, eager reference state, its tokens]
    parts = [[su.take(st, ids), su.rows(tok, ids),
              su.take(st, ids), su.rows(tok, ids)]
             for ids in ([0, 1, 2], [3, 4, 5])]
    del st
    held = []                      # (logits returned, a copy made then)

    def rounds(n):
        for _ in range(n):
            for p in parts:
                ptrs = _ptrs(p[0])
                ops.reset_launches()
                logits, new = decode(params, p[0], p[1])
                got = dict(ops.launches)
                held.append((logits, logits.clone()))
                ops.reset_launches()
                want, p[2] = T.decode_step(params, p[2], p[3], cfg, rt)
                assert got == dict(ops.launches)
                assert new is p[0] and _ptrs(new) == ptrs
                if dtype == "float32":
                    assert torch.equal(logits.argmax(-1), want.argmax(-1))
                    torch.testing.assert_close(logits, want, rtol=1e-4,
                                               atol=1e-4)
                else:
                    gap = (logits.float() - want.float()).abs().max()
                    assert gap <= _bf16_tol(want.float())
                p[1] = logits.argmax(-1)[:, None]
                p[3] = want.argmax(-1)[:, None]

    with torch.no_grad():
        rounds(3)
        assert decode.captures == 2 and decode.live == 2
        # the re-cut: row 0 of each part changes sides
        swap = [([(0, [0]), (1, [1, 2])]), ([(1, [0]), (0, [1, 2])])]
        parts[:] = [[su.concat([su.take(parts[i][k], ids) for i, ids in cut])
                     if k in (0, 2) else
                     torch.cat([su.rows(parts[i][k], ids) for i, ids in cut])
                     for k in range(4)] for cut in swap]
        gc.collect()
        assert decode.live == 0
        rounds(3)
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in held)
    assert (decode.captures, decode.replays, decode.eager) == (4, 12, 0)


@pytest.mark.cuda
def test_cuda_events_inside_the_step_stay_readable(cuda, monkeypatch):
    """A caller's timing events around a layer inside the step (as the
    benchmark's per-layer timers record them) are graph event nodes:
    ``elapsed_time`` reads the last replay."""
    cfg, params = _model("deepseek-moe-16b", device=cuda)
    rt = T.Runtime(use_kernels=True)
    decode = make_decode_fn(cfg, rt)
    events = []
    inner = moe.moe_forward

    def timed(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(*a, **kw)
        e.record()
        events.append((s, e))
        return out

    monkeypatch.setattr(moe, "moe_forward", timed)
    tok, st = _prefill(cfg, params, rt, 2)
    events.clear()
    with torch.no_grad():
        for _ in range(3):
            logits, st = decode(params, st, tok)
            tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert decode.captures == 1 and decode.replays == 3
    # the warm-up's eager step and the capture each timed every layer
    assert len(events) == 2 * cfg.num_layers
    assert all(s.elapsed_time(e) >= 0 for s, e in events)
