"""One run of a serving cell through the port's ``FleetEngine``.

Set-up builds the port's ``ModelConfig`` from the configuration file, the
weights from the seed on the device (:mod:`.weights`), and one
``FleetEngine`` (object engine, the cell's groups, slots, window and
router, the default ``AmoebaConfig``, ``Runtime(use_kernels=True)``), then
prefills every prompt length of the mix and decodes at the slot count.
The window opens at the first due request.

The harness owns the wall clock.  Between engine ticks it submits every
request whose due time has passed (``arrival`` = the engine's tick) and
advances the engine one tick through the public, resumable
``run(max_ticks=wall + 1)``.  A token is stamped with the host time at
which the host holds it: the start of the next prefill or decode call,
or the end of the tick, whichever comes first; each of those follows the
read-back (``tolist``) that produced the token.  The decode calls are
seen through ``FleetEngine``'s ``decode_fn`` argument, the prefill calls
through the model's ``transformer.prefill``; a window whose tokens came
without such a call (a hook that no longer takes effect) raises.  A
group whose topology changed over a tick marks its live requests as
re-cut.  An open loop's due times come from the mix; a closed loop's
clients each send their next request when the last one finishes.

A traced run (``--trace 1``) adds CUDA events and host times around the
model's prefill and decode calls and around whatever the cell's
per-layer readers ask for (``WRAP``), host annotations around the
engine's ticks and group steps, and ``torch.profiler`` over two
sub-windows of whole ticks.

Once the window has closed the run reads the peak memory, frees the
engine's state and checks a sample of the finished requests against the
plain reference (:mod:`.check`).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from port_bench.harness import check, manifest, trace, weights
from port_bench.harness.stats import censored, percentile
from port_bench.harness.traffic import Mix

clock = time.perf_counter

# profiler sub-windows: where they open (share of the window), the least
# they last, and the most when no prefill call has come
SUBWINDOW_AT = (0.3, 0.65)
SUBWINDOW_MIN_S = 1.5
SUBWINDOW_MAX_S = 15.0


@dataclass
class Rec:
    """One request as the harness sees it."""
    req: object
    due: float
    client: Optional[int] = None
    seen: int = 0
    first: Optional[float] = None        # host time of its first token
    first_tick: Optional[float] = None   # start of the tick that gave it
    first_call: Optional[float] = None   # start of the prefill call
    first_in: Optional[float] = None     # first and last token stamped by
    last_in: Optional[float] = None      # the window's close
    n_in: int = 0
    reconfigured: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)


@dataclass
class Record:
    """Everything a per-layer reader may read, in plain values."""
    cell: manifest.Cell
    model: dict
    seconds: float
    open_t: float
    close_t: float
    requests: List[Rec]
    counters: Dict[str, int]
    prefills: List[dict] = field(default_factory=list)
    decodes: List[dict] = field(default_factory=list)
    wrapped: Dict[str, List[dict]] = field(default_factory=dict)
    subwindows: List[dict] = field(default_factory=list)

    def due_in_window(self) -> List[Rec]:
        return [r for r in self.requests if self.open_t <= r.due < self.close_t]


def model_config(cfg_file: dict):
    """The port's ``ModelConfig`` from a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    m = dict(cfg_file["model"])
    if m.get("moe"):
        m["moe"] = MoEConfig(**m["moe"])
    if m.get("ssm"):
        m["ssm"] = SSMConfig(**m["ssm"])
    for k in ("block_pattern", "mrope_sections"):
        if k in m and m[k] is not None:
            m[k] = tuple(m[k])
    return ModelConfig(**m)


def fleet_config(spec: dict):
    from repro_torch.configs.base import AmoebaConfig, FleetConfig
    e = dict(spec["engine"])
    e["amoeba"] = AmoebaConfig(**e.get("amoeba", {}))
    return FleetConfig(**e)


class Run:
    """One run: set-up, the window, the readings and the check."""

    def __init__(self, root: Path, cell: manifest.Cell, seed: int,
                 seconds: float, traced: bool, device: str = "cuda",
                 t_start: Optional[float] = None,
                 model_override: Optional[dict] = None,
                 fault: Optional[str] = None):
        self.root = Path(root)
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = clock() if t_start is None else t_start
        self.model = dict(model_override or cell.config["model"])
        self.fault = fault
        self.recs: List[Rec] = []
        self.active: List[Rec] = []
        self.by_req: Dict[int, Rec] = {}
        self.next_due: Dict[int, Optional[float]] = {}
        self.sub_open = None
        self.tick_start = 0.0
        self.close_t = float("inf")
        self.in_prefill = 0
        self.call_start = None
        self.prefills: List[dict] = []
        self.decodes: List[dict] = []
        self.wrapped: Dict[str, List[dict]] = {}
        self.profs: List[object] = []
        self.readers = manifest.readers(self.root, cell.per_layer) \
            if traced else {}

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.fleet import FleetEngine
        from repro_torch.kernels import _build
        from repro_torch.models import transformer as T
        from repro_torch.serve.engine import make_decode_fn
        self.T = T
        if self.cuda:
            _build.build_all()
        self.cfg = model_config({"model": self.model})
        meta = T.init_model(self.cfg, torch.Generator(), device="meta")
        self.params = weights.make(meta, self.seed, self.device)
        self.rt = T.Runtime(use_kernels=True)
        self.fleet = fleet_config(self.cell.spec)
        self.mix = Mix(self.cell.traffic, self.seed, self.cfg.vocab_size)
        self.eng = FleetEngine(self.cfg, self.params, rt=self.rt,
                               fleet=self.fleet,
                               decode_fn=self._decode_fn(
                                   make_decode_fn(self.cfg, self.rt)))
        self._warm()
        self._hook()

    def _warm(self) -> None:
        """Each prompt length at the batch a wave gives it most often, and
        a decode at the slot count (from the shortest prompt)."""
        T, slots = self.T, self.fleet.capacity
        w = self.fleet.window
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        lens = self.mix.prompt_lengths()
        weights_by_len = {}
        for c in self.cell.traffic["prompt"]:
            n = int(c["hi"]) - int(c["lo"]) + 1
            for L in range(int(c["lo"]), int(c["hi"]) + 1):
                weights_by_len[L] = weights_by_len.get(L, 0) + c["weight"] / n
        with torch.no_grad():
            for L in lens:
                b = max(1, math.ceil(slots * weights_by_len[L]))
                if L == lens[0]:
                    b = slots
                toks = torch.randint(0, self.cfg.vocab_size, (b, L),
                                     generator=gen, device=self.device)
                logits, st = T.prefill(self.params, {"tokens": toks},
                                       self.cfg, self.rt, window=w)
                logits.argmax(-1).tolist()
                if L == lens[0]:
                    nxt = logits.argmax(-1)[:, None]
                    for _ in range(2):
                        logits, st = T.decode_step(self.params, st, nxt,
                                                   self.cfg, self.rt)
                        nxt = logits.argmax(-1)[:, None]
                        nxt.tolist()
                del logits, st
        if self.cuda:
            torch.cuda.synchronize()

    # -- hooks -------------------------------------------------------------------

    def _annot(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _events(self):
        if not (self.traced and self.cuda):
            return None, None
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        return s, e

    def _hook(self) -> None:
        """Stamps in every run; spans and annotations in a traced one."""
        T = self.T
        orig_prefill = T.prefill
        run = self

        def prefill(params, batch, *a, **kw):
            run.boundary(clock())
            B, S = batch["tokens"].shape
            t = run.call_start = clock()
            s, e = run._events()
            run.in_prefill += 1
            try:
                with run._annot("model.prefill"):
                    out = orig_prefill(params, batch, *a, **kw)
            finally:
                run.in_prefill -= 1
            if e is not None:
                e.record()
            run.prefills.append(dict(batch=B, seq=S, start=t, end=clock(),
                                     ev=(s, e), profiled=run._profiling()))
            return out

        T.prefill = prefill
        self._restore = [(T, "prefill", orig_prefill)]
        for mod_name, attr in sorted({w for r in self.readers.values()
                                      for w in getattr(r, "WRAP", ())}):
            self._wrap(importlib.import_module(mod_name), attr)
        if self.traced:
            for g in self.eng.groups:
                self._annotate_step(g)

    def _decode_fn(self, decode: Callable) -> Callable:
        """``decode`` as the engine gets it: a stamp before each call, its
        host time and CUDA events, and the planted fault, if any."""
        run = self

        def decode_fn(p, s, t):
            run.boundary(clock())
            old = _clone_state(s) if run.fault == "stale_state" else None
            h = clock()
            ev_s, ev_e = run._events()
            with run._annot("model.decode_enqueue"):
                logits, st = decode(p, s, t)
            if ev_e is not None:
                ev_e.record()
            run.decodes.append(dict(batch=t.shape[0], start=h,
                                    host_s=clock() - h, ev=(ev_s, ev_e),
                                    profiled=run._profiling()))
            if old is not None:
                return logits, old
            if run.fault == "token":
                logits = logits.clone()
                logits[:, 0] = logits.max(-1).values + 1.0
            return logits, st

        return decode_fn

    def _wrap(self, mod, attr: str) -> None:
        fn = getattr(mod, attr)
        spans = self.wrapped.setdefault(f"{mod.__name__}.{attr}", [])
        run = self

        def wrapped(*a, **kw):
            s, e = run._events()
            with run._annot(f"model.{attr}"):
                out = fn(*a, **kw)
            if e is not None:
                e.record()
                spans.append(dict(ev=(s, e), start=clock(),
                                  phase="prefill" if run.in_prefill
                                  else "decode", profiled=run._profiling()))
            return out

        setattr(mod, attr, wrapped)
        self._restore.append((mod, attr, fn))

    def _annotate_step(self, g) -> None:
        step = g.step

        def step_(*a, **kw):
            with self._annot("group.step"):
                return step(*a, **kw)
        g.step = step_

    def unhook(self) -> None:
        for mod, attr, fn in reversed(getattr(self, "_restore", [])):
            setattr(mod, attr, fn)
        self._restore = []

    # -- stamps ------------------------------------------------------------------

    def boundary(self, t: float) -> None:
        """Stamp the tokens that appeared since the last boundary."""
        still = []
        for rec in self.active:
            n = len(rec.req.generated)
            if n > rec.seen:
                if rec.seen == 0:
                    rec.first, rec.first_tick = t, self.tick_start
                    rec.first_call = self.call_start
                if t <= self.close_t:
                    if rec.first_in is None:
                        rec.first_in = t
                    rec.last_in = t
                    rec.n_in += n - rec.seen
                rec.seen = n
            if rec.req.done:
                if rec.client is not None:
                    self.next_due[rec.client] = t
            else:
                still.append(rec)
        self.active = still

    # -- the window ----------------------------------------------------------------

    def _send(self, due: float, client: Optional[int] = None) -> None:
        from repro_torch.serve.engine import Request
        i = len(self.recs)
        _, out_len = self.mix.size(i)
        req = Request(rid=i, prompt=self.mix.tokens(i),
                      max_new_tokens=out_len, arrival=self.eng.wall)
        rec = Rec(req=req, due=due, client=client)
        self.recs.append(rec)
        self.active.append(rec)
        self.by_req[id(req)] = rec
        self.eng.submit([req])

    def _submit_due(self, now: float) -> None:
        if self.mix.loop == "open":
            while self.next_open < len(self.due) \
                    and self.due[self.next_open] <= now:
                self._send(self.due[self.next_open])
                self.next_open += 1
        else:
            for c, due in list(self.next_due.items()):
                if due is not None and due <= now:
                    self.next_due[c] = None
                    self._send(due, client=c)

    def window(self) -> None:
        load = self.cell.spec["load"]
        now = clock()
        self.open_t = now
        self.close_t = now + self.seconds
        if self.mix.loop == "open":
            offs = self.mix.due_times(float(load["rate_per_s"]),
                                      self.seconds)
            self.due = [now + float(o) for o in offs]
            self.next_open = 0
            self.next_due = {}
        else:
            self.next_due = {c: now for c in range(int(load["clients"]))}
        self.stats0 = self._counters()
        self.sub_i, self.sub_open = 0, None
        while True:
            now = clock()
            if now >= self.close_t:
                break
            self._submit_due(now)
            self._profile_tick(now)
            if not self.active:
                nxt = self.due[self.next_open] \
                    if self.mix.loop == "open" \
                    and self.next_open < len(self.due) else self.close_t
                time.sleep(max(0.0, min(nxt, self.close_t) - clock()))
                continue
            self.tick_start = now
            wall = self.eng.wall
            cuts = [g.topology for g in self.eng.groups]
            with self._annot("engine.run"):
                self.eng.run(max_ticks=wall + 1)
            self.boundary(clock())
            if self.eng.wall == wall:
                raise RuntimeError("the engine made no tick with "
                                   f"{len(self.active)} requests in flight")
            self._mark_recut(cuts)
        self._profile_stop()
        self.stats1 = self._counters()
        self._check_spans()

    def _mark_recut(self, cuts) -> None:
        """Mark the live requests of each group whose topology changed."""
        for g, cut in zip(self.eng.groups, cuts):
            if g.topology != cut:
                for r in g.live_requests():
                    rec = self.by_req.get(id(r))
                    if rec is not None:
                        rec.reconfigured = True

    def _check_spans(self) -> None:
        """Tokens with no prefill or decode call seen: the stamps and
        spans would silently fall to the ends of ticks."""
        if any(r.seen >= 1 for r in self.recs) and not self.prefills:
            raise RuntimeError("first tokens came, but no prefill call was "
                               "seen: the prefill hook did not take effect")
        if any(r.seen >= 2 for r in self.recs) and not self.decodes:
            raise RuntimeError("decoded tokens came, but no decode call was "
                               "seen: the decode_fn hook did not take effect")

    def _counters(self) -> Dict[str, int]:
        keys = ("useful_tokens", "slot_steps", "prefill_tokens", "splits",
                "fuses", "resizes", "completed")
        return {k: sum(getattr(g.stats, k) for g in self.eng.groups)
                for k in keys}

    # -- profiler sub-windows ---------------------------------------------------

    def _profiling(self) -> bool:
        return self.sub_open is not None

    def _profile_tick(self, now: float) -> None:
        if not (self.traced and self.cuda):
            return
        if self.sub_open is None:
            if self.sub_i < len(SUBWINDOW_AT) and \
                    now >= self.open_t + SUBWINDOW_AT[self.sub_i] * self.seconds:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                ann = torch.profiler.record_function(trace.SUBWINDOW)
                ann.__enter__()
                self.sub_open = (prof, ann, now, len(self.prefills))
            return
        _, _, since, n_pre = self.sub_open
        long_enough = now - since >= SUBWINDOW_MIN_S and (
            len(self.prefills) > n_pre or now - since >= SUBWINDOW_MAX_S)
        if long_enough:
            self._profile_stop()

    def _profile_stop(self) -> None:
        if self.sub_open is None:
            return
        prof, ann, _, _ = self.sub_open
        torch.cuda.synchronize()
        ann.__exit__(None, None, None)
        prof.stop()
        self.profs.append(prof)
        self.sub_open = None
        self.sub_i += 1

    # -- readings ------------------------------------------------------------------

    def record(self) -> Record:
        if self.cuda:
            torch.cuda.synchronize()
        ms = lambda ev: ev[0].elapsed_time(ev[1]) \
            if ev[0] is not None else None  # noqa: E731
        for lst in [self.prefills, self.decodes, *self.wrapped.values()]:
            for item in lst:
                item["device_ms"] = ms(item.pop("ev"))
        counters = {k: self.stats1[k] - self.stats0[k] for k in self.stats0}
        return Record(cell=self.cell, model=self.model,
                      seconds=self.seconds, open_t=self.open_t,
                      close_t=self.close_t, requests=self.recs,
                      counters=counters, prefills=self.prefills,
                      decodes=self.decodes, wrapped=self.wrapped,
                      subwindows=[trace.extract(p) for p in self.profs])

    def end_to_end(self, rec: Record) -> Dict[str, float]:
        out = end_to_end(rec, {m["name"] for m in self.cell.end_to_end})
        out["setup_s"] = self.open_t - self.t_start
        return out

    def per_layer(self, rec: Record) -> Dict[str, float]:
        out = {}
        for name, mod in self.readers.items():
            v = mod.read(rec)
            if v is not None:
                out[name] = v
        return out

    def lost(self) -> int:
        """Requests submitted that are neither done, live nor queued."""
        held = set()
        for g in self.eng.groups:
            held.update(id(r) for r in g.queue)
            held.update(id(r) for r in g.live_requests())
        return sum(1 for r in self.recs
                   if not r.req.done and id(r.req) not in held)

    def release(self) -> None:
        """Free the engine and its decode state; the weights stay."""
        self.unhook()
        for g in self.eng.groups:
            g._parts = [None] * len(g._parts)
        del self.eng
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def end_to_end(rec: Record, names) -> Dict[str, float]:
    """The window's end-to-end metrics named in ``names`` (all but
    ``setup_s``, which is the run's).

    * ``ttft_p90_s``: over every request due in the window, due time to
      first token, censored at the close for a request without one;
    * ``itl_p90_ms``: over every request with two or more tokens stamped
      in the window, its mean gap, first to last token over n - 1;
    * ``prompt_tok_s``: prompt tokens prefilled in the window, over the
      whole window: a request's prompt counts whole where its first token
      came by the close, and by the share of its prefill call (the call's
      start to its first token) that lies before the close where the call
      straddles it, so that the rate does not step by a call's tokens;
    * ``output_tok_s``: every output token stamped in the window (first
      tokens included), over the whole window.
    """
    out = {}
    if "ttft_p90_s" in names:
        out["ttft_p90_s"] = percentile(censored(
            [(r.due, r.first) for r in rec.due_in_window()], rec.close_t), 90)
    if "itl_p90_ms" in names:
        itl = [(r.last_in - r.first_in) / (r.n_in - 1) * 1e3
               for r in rec.requests if r.n_in >= 2]
        out["itl_p90_ms"] = percentile(itl, 90)
    if "prompt_tok_s" in names:
        toks = sum(r.prompt_len * prefilled_share(r, rec.close_t)
                   for r in rec.requests)
        out["prompt_tok_s"] = toks / rec.seconds
    if "output_tok_s" in names:
        out["output_tok_s"] = sum(r.n_in for r in rec.requests) / rec.seconds
    return out


def prefilled_share(r: Rec, close_t: float) -> float:
    """The share of ``r``'s prefill done by ``close_t``: 1 where its first
    token came by then, else the share of its prefill call's span before
    the close (0 for a call started after it, or none)."""
    if r.first is None or r.first_call is None:
        return 0.0
    if r.first <= close_t:
        return 1.0
    span = r.first - r.first_call
    return min(1.0, max(0.0, close_t - r.first_call) / span) if span > 0 \
        else 0.0


def _clone_state(s):
    """A copy of a decode state (a fault's: the state the step leaves)."""
    if isinstance(s, torch.Tensor):
        return s.clone()
    if isinstance(s, dict):
        return {k: _clone_state(v) for k, v in s.items()}
    if isinstance(s, tuple):
        items = [_clone_state(v) for v in s]
        return type(s)(*items) if hasattr(s, "_fields") else tuple(items)
    return s


def run_cell(root: Path, cell: manifest.Cell, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             model_override: Optional[dict] = None,
             fault: Optional[str] = None,
             device_info: Optional[Callable[[], dict]] = None) -> dict:
    """One run; returns the result line's fields (``compared`` last).

    ``fault`` breaks the timed path underneath (``"token"``: every decoded
    token replaced; ``"stale_state"``: each decode step returns the state
    it was given), or, as ``"control"``, leaves the program alone and puts
    the float8 control in its place where the check is judged: the same
    sample is compared with the same limits, and the program's own
    reading stays beside the control's in ``sample``."""
    control = fault == "control"
    run = Run(root, cell, seed, seconds, traced, device, t_start,
              model_override, None if control else fault)
    run.setup()
    run.window()
    rec = run.record()
    metrics_e2e = run.end_to_end(rec)
    per_layer = run.per_layer(rec) if traced else {}
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    lost = run.lost()
    run.release()
    sample = check.choose(rec.requests, cell.spec["check"], seed)
    readings = check.gaps(run.model, run.params, sample, run.device,
                          control=control)
    judged = {k[len("control_"):]: v for k, v in readings.items()
              if k.startswith("control_")} if control else readings
    compared = check.compare(judged, cell.spec["check"]["limits"])
    due = rec.due_in_window()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    chosen = per_layer if traced else metrics_e2e
    device = device_info() if device_info else {}
    device["memory_peak_bytes"] = int(peak)
    if traced and rec.subwindows:
        busy = sum(trace.busy_window_us(s)[0] for s in rec.subwindows)
        win = sum(trace.busy_window_us(s)[1] for s in rec.subwindows)
        device["busy_s"] = busy * 1e-6
        device["window_s"] = win * 1e-6
    result = {
        "correct": bool(sample) and lost == 0
        and all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": len(due),
        "failed": lost,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in chosen.items() if v is not None},
        "device": device,
    }
    if traced and rec.subwindows:
        result["breakdown"] = trace.breakdown(rec.subwindows)
    result["sample"] = {"requests": len(sample),
                        "served_tokens": readings["served"],
                        "reference_s": readings["seconds"],
                        "flips": readings["flips"],
                        "max_gap": readings["max_gap"]}
    if control:
        result["sample"].update(
            {k: v for k, v in readings.items()
             if k.startswith("control_") or k == "mean_gap"})
    result["compared"] = compared
    return result

