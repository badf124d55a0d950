"""A whole run on the CPU at a tiny width (the card check skipped), and
the same run with the timed path broken underneath: ``correct`` must come
out false for every fault a serving cell can have."""
import types

import pytest

from conftest import ROOT, tiny_cell
from port_bench.harness import check, serve

SEED = 2**31 + 4242


@pytest.mark.parametrize("name", ["dsmoe16b-docs", "fmamba7b-rag"])
@pytest.mark.parametrize("fault", [None, "token", "stale_state"])
def test_correct_holds_and_each_fault_breaks_it(root, name, fault):
    cell, model = tiny_cell(name)
    res = serve.run_cell(root, cell, SEED, 2.0, False, device="cpu",
                         model_override=model, fault=fault)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["sample"]["served_tokens"] > 0
    assert list(res)[-1] == "compared"
    assert res["correct"] is (fault is None), res["compared"]
    names = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == names


def test_traced_run_reads_its_per_layer_metrics(root):
    cell, model = tiny_cell("fmamba7b-rag")
    res = serve.run_cell(root, cell, SEED, 2.0, True, device="cpu",
                         model_override=model)
    assert res["correct"]
    # the CPU has no CUDA events and no device trace: those readers find
    # nothing and their metrics are left out
    assert {"slot_efficiency.chat", "queue_wait_p50_s.chat",
            "decode_host_ms.chat", "mfu.chat"} <= set(res["metrics"])
    assert "decode_device_ms.chat" not in res["metrics"]
    assert "device_idle_share.chat" not in res["metrics"]


def test_the_sample_holds_the_longest_and_a_reconfigured_request():
    class R:
        def __init__(self, rid, plen, n, moved=False):
            self.req = type("Q", (), {})()
            self.req.rid, self.req.prompt = rid, [0] * plen
            self.req.generated, self.req.done = [1] * n, True
            self.reconfigured = moved

        @property
        def prompt_len(self):
            return len(self.req.prompt)

    recs = [R(i, 100, 10) for i in range(50)] + [R(50, 1000, 64),
                                                 R(51, 100, 9, moved=True)]
    pick = check.choose(recs, {"ref_tokens": 2000}, 7)
    assert pick[0].req.rid == 50 and pick[1].req.rid == 51
    assert sum(r.prompt_len + len(r.req.generated) for r in pick) <= 2000
    assert pick == check.choose(recs, {"ref_tokens": 2000}, 7)


def test_the_sample_prefers_the_shortest_prompts():
    class R:
        def __init__(self, rid, plen):
            self.req = type("Q", (), {})()
            self.req.rid, self.req.prompt = rid, [0] * plen
            self.req.generated, self.req.done = [1] * 8, True
            self.reconfigured = False

        @property
        def prompt_len(self):
            return len(self.req.prompt)

    recs = [R(i, (2048, 4096, 8192)[i % 3]) for i in range(30)]
    pick = check.choose(recs, {"ref_tokens": 8200 + 4 * 2056}, 3)
    assert pick[0].prompt_len == 8192
    assert [r.prompt_len for r in pick[1:]] == [2048] * 4
    assert len({r.req.rid for r in pick[1:]}) == 4


def _run_without_window(name):
    cell, model = tiny_cell(name)
    run = serve.Run(ROOT, cell, SEED, 1.0, False, device="cpu",
                    model_override=model)
    run.setup()
    return run


def test_a_hook_that_takes_no_effect_fails_the_run():
    run = _run_without_window("dsmoe16b-docs")
    run.unhook()                  # the prefill calls go unseen
    with pytest.raises(RuntimeError, match="prefill"):
        run.window()
    run = _run_without_window("dsmoe16b-docs")
    plain = lambda p, s, t: run.T.decode_step(p, s, t, run.cfg,  # noqa
                                              run.rt)
    for g in run.eng.groups:      # the decode calls go unseen
        g._decode = plain
    with pytest.raises(RuntimeError, match="decode"):
        run.window()


def test_a_topology_change_marks_the_groups_live_requests():
    run = serve.Run.__new__(serve.Run)
    reqs = [object() for _ in range(4)]
    run.by_req = {id(r): serve.Rec(req=r, due=0.0) for r in reqs}
    cut = types.SimpleNamespace(topology=(4,),
                                live_requests=lambda: reqs[:2])
    still = types.SimpleNamespace(topology=(4,),
                                  live_requests=lambda: reqs[2:])
    run.eng = types.SimpleNamespace(groups=[cut, still])
    before = [(8,), (4,)]
    run._mark_recut(before)
    assert [run.by_req[id(r)].reconfigured for r in reqs] == \
        [True, True, False, False]
