"""The plain reference against the port at a tiny width on the CPU (the
port's kernels run their plain versions there), and the reference's
chunked scan against the step-by-step recurrence."""
import pytest
import torch

from conftest import TINY
from port_bench.harness import manifest, serve, weights
from port_bench.reference.model import Plain, fake_fp8, selective_scan


def _port(root, name):
    cfg_file = manifest.load_json(root / "port_bench" / "configs"
                                  / f"{name}.json")
    model = {**cfg_file["model"], **TINY[name]}
    from repro_torch.models import transformer as T
    cfg = serve.model_config({"model": model})
    params = weights.make(T.init_model(cfg, torch.Generator(),
                                       device="meta"), 2**31 + 5, "cpu")
    return T, cfg, model, params


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_matches_the_port_through_prefill_and_decode(root, name):
    T, cfg, model, params = _port(root, name)
    rt = T.Runtime(use_kernels=True)
    g = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    with torch.no_grad():
        logits, st = T.prefill(params, {"tokens": prompts}, cfg, rt,
                               window=40)
        got, toks = [logits], [logits.argmax(-1)]
        for _ in range(6):
            logits, st = T.decode_step(params, st, toks[-1][:, None], cfg, rt)
            got.append(logits)
            toks.append(logits.argmax(-1))
        got = torch.stack(got, 1)                     # (B, 7, V)
        served = torch.stack(toks, 1)                 # (B, 7)
        seqs = [torch.cat([prompts[b], served[b, :-1]]) for b in range(2)]
        pos = [torch.arange(23, 30)] * 2
        ref = Plain(model, weights.reference_view(params, 1)).logits_at(
            seqs, pos)
    for b in range(2):
        scale = 1.0 + ref[b].abs().max()
        assert (got[b] - ref[b]).abs().max() <= 1e-4 * scale, name


def test_reference_reads_the_programs_tensors(root):
    _, _, _, params = _port(root, "deepseek-moe-16b")
    view = weights.reference_view(params, 1)
    assert len(view["layers"]) == 2
    wq = view["layers"][1]["mixer.wq"]
    assert wq.data_ptr() == params["reps"][0]["mixer"]["wq"][1].data_ptr()
    assert view["unembed"] is params["embed"]["out"]


def test_same_seed_same_weights_other_seed_other(root):
    from repro_torch.models import transformer as T
    _, cfg, _, p1 = _port(root, "falcon-mamba-7b")
    meta = T.init_model(cfg, torch.Generator(), device="meta")
    p2 = weights.make(meta, 2**31 + 5, "cpu")
    p3 = weights.make(meta, 2**31 + 6, "cpu")
    for a, b, c in zip(weights.leaves(p1), weights.leaves(p2),
                       weights.leaves(p3)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
        if a[0][-1] in ("in_proj", "table"):
            assert not torch.equal(a[1], c[1])
        base = a[1].untyped_storage().data_ptr()
        assert (a[1].data_ptr() - base) % weights.ALIGN == 0


def _scan_loop(dt, x, A, Bm, Cm):
    h = torch.zeros(dt.shape[1], A.shape[1], dtype=torch.float64)
    ys = []
    for t in range(dt.shape[0]):
        h = torch.exp(dt[t, :, None] * A) * h \
            + (dt[t] * x[t])[:, None] * Bm[t][None]
        ys.append(h @ Cm[t])
    return torch.stack(ys)


@pytest.mark.parametrize("S, chunk", [(1, 64), (7, 3), (130, 64), (64, 64)])
def test_chunked_scan_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    D, N = 5, 4
    dt = torch.rand(S, D, generator=g) * 0.5
    x = torch.randn(S, D, generator=g)
    A = -torch.rand(D, N, generator=g) * 4
    Bm, Cm = torch.randn(S, N, generator=g), torch.randn(S, N, generator=g)
    got = selective_scan(dt, x, A, Bm, Cm, chunk=chunk)
    want = _scan_loop(*(t.double() for t in (dt, x, A, Bm, Cm)))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_fp8_control_rounds_to_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.1, 448.0, -3.3]])
    q = fake_fp8(t, -1)
    assert q[0, 2] == 448.0
    assert q[0, 0] == 1.0
    assert q[0, 1] != 1.1 and abs(q[0, 1] - 1.1) <= 1.1 / 16
    with pytest.raises(ValueError):
        Plain({"family": "moe", "num_layers": 1}, {}, "int3")
