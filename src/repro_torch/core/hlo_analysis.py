"""Loop-aware analysis of post-optimization HLO.

``compiled.cost_analysis()`` counts every while-loop body ONCE, so a
96-layer scan + grad-accum + chunked-loss program under-reports FLOPs,
bytes, and collective payloads by 2-3 orders of magnitude.  This module
parses the compiled HLO module text, reconstructs the call graph
(while bodies, fusions, calls, conditionals), extracts loop trip counts,
and tallies:

* ``flops``            — 2 x |result| x contracted-dim product per dot,
                         trip-count weighted (matmul-dominated programs:
                         this is the real compute term).
* ``collective_bytes`` — result-shape payload of every all-gather /
                         all-reduce / reduce-scatter / all-to-all /
                         collective-permute, trip-count weighted.
* ``hbm_bytes``        — estimator: every top-level op result is written
                         once and read ~once downstream (2x result bytes),
                         plus the entry arguments read once; documented in
                         EXPERIMENTS.md §Roofline.

Trip counts: jax scans lower to ``while`` whose condition is
``compare(%iter, %bound), direction=LT``; both iter-init and bound arrive
through the init tuple, so the bound is recovered by tracing the compare's
condition-parameter index back to the init-tuple operand in the parent
computation (a constant).  Unresolvable loops fall back to trip=1 and are
counted in ``unresolved_loops``.

Counterpart of ``repro/core/hlo_analysis.py``: plain Python over HLO text,
ported as it is, so both packages give equal ``HLOCost``s on the same text.
The port compiles no HLO; it reads the reference's HLO artifacts, and its
own steps are tallied in the same units by ``repro_torch.core.step_count``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s32": 4, "u32": 4,
          "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8, "s16": 2,
          "u16": 2, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_PARAM_RE = re.compile(r"([\w.\-]+)\s*:")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+)$")
_OPCODE_RE = re.compile(
    r"^((?:\([^=]*?\))|[\w\[\]{},\/\*=\s]+?)\s*([\w\-]+)\(")

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_SKIP_RESULT_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
                    "bitcast", "while", "conditional", "call", "after-all",
                    "partition-id", "replica-id", "iota"}


def _shape_list(text: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _BYTES:
            continue
        out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _shape_list(text):
        n = 1
        for d in dims:
            n *= d
        total += n * _BYTES[dt]
    return total


@dataclass
class Instruction:
    name: str
    opcode: str
    result_text: str
    body: str
    operands_text: str


@dataclass
class Computation:
    name: str
    params: List[str] = field(default_factory=list)
    instrs: List[Instruction] = field(default_factory=list)
    by_name: Dict[str, Instruction] = field(default_factory=dict)
    constants: Dict[str, int] = field(default_factory=dict)


def _split_opcode(rhs: str):
    """rhs: '<result types> <opcode>(<operands>), attrs' -> pieces."""
    # find the first opcode token immediately followed by '('
    m = re.search(r"([\w\-]+)\(", rhs)
    while m:
        op = m.group(1)
        # opcode must be preceded by whitespace or start (not part of type)
        pre = rhs[:m.start()].strip()
        if pre.endswith(("]", ")", "}")) or pre == "" or pre[-1].isspace():
            return pre, op, rhs[m.end() - 1:]
        m = re.search(r"([\w\-]+)\(", rhs[m.end():])
        if m:
            m = re.search(re.escape(m.group(0)), rhs)
            break
    return None, None, None


def parse_module(hlo: str) -> Tuple[Dict[str, Computation], Optional[str]]:
    comps: Dict[str, Computation] = {}
    entry = None
    cur: Optional[Computation] = None
    for raw in hlo.splitlines():
        s = raw.strip()
        if not s or s.startswith("//") or s.startswith("HloModule"):
            continue
        is_hdr = (") -> " in s and s.endswith("{") and " = " not in s
                  and (s.startswith("%") or s.startswith("ENTRY")))
        if is_hdr:
            name_m = re.match(r"(?:ENTRY\s+)?%([\w.\-]+)\s*\(", s)
            if not name_m:
                continue
            cur = Computation(name_m.group(1))
            hdr_args = s[s.index("("):s.rindex(") -> ")]
            cur.params = _PARAM_RE.findall(hdr_args)
            comps[cur.name] = cur
            if s.startswith("ENTRY"):
                entry = cur.name
            continue
        if s == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _INSTR.match(s)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        om = re.search(r"\s([\w\-]+)\(", " " + rhs)
        if not om:
            continue
        opcode = om.group(1)
        result_text = rhs[:om.start(1) - 1].strip()
        # operands: balanced paren group right after opcode
        start = om.start(1) - 1 + len(opcode) + 1
        depth, i = 1, start + 1
        while i < len(rhs) and depth:
            if rhs[i] == "(":
                depth += 1
            elif rhs[i] == ")":
                depth -= 1
            i += 1
        operands = rhs[start:i]
        ins = Instruction(name, opcode, result_text, rhs, operands)
        cur.instrs.append(ins)
        cur.by_name[name] = ins
        if opcode == "constant":
            lit = re.search(r"constant\((-?\d+)\)", rhs)
            if lit and re.match(r"^[su]\d+\[\]", result_text):
                cur.constants[name] = int(lit.group(1))
    return comps, entry


def _operand_names(ins: Instruction) -> List[str]:
    return re.findall(r"%([\w.\-]+)", ins.operands_text)


def _resolve_trip(while_ins: Instruction, parent: Computation,
                  comps: Dict[str, Computation]) -> Optional[int]:
    cm = re.search(r"condition=%?([\w.\-]+)", while_ins.body)
    if not cm or cm.group(1) not in comps:
        return None
    cond = comps[cm.group(1)]
    # init tuple in the parent (possibly behind copies)
    init_names = _operand_names(while_ins)
    init_ops: Optional[List[str]] = None
    if len(init_names) == 1 and init_names[0] in parent.by_name \
            and parent.by_name[init_names[0]].opcode == "tuple":
        init_ops = _operand_names(parent.by_name[init_names[0]])
    elif len(init_names) > 1:
        init_ops = init_names

    def chase_parent_const(name: str, depth: int = 0) -> Optional[int]:
        if depth > 4:
            return None
        if name in parent.constants:
            return parent.constants[name]
        ins = parent.by_name.get(name)
        if ins is not None and ins.opcode in ("copy", "convert", "bitcast"):
            ops = _operand_names(ins)
            if ops:
                return chase_parent_const(ops[0], depth + 1)
        return None

    def init_const(idx: int) -> Optional[int]:
        if init_ops is None or idx >= len(init_ops):
            return None
        return chase_parent_const(init_ops[idx])

    def value_in_cond(name: str) -> Optional[int]:
        """Resolve an s32[] value referenced inside the condition."""
        if name in cond.constants:
            return cond.constants[name]
        if name in cond.params:
            return init_const(cond.params.index(name))
        ins = cond.by_name.get(name)
        if ins is None:
            return None
        if ins.opcode == "get-tuple-element":
            im = re.search(r"index=(\d+)", ins.body)
            if im:
                return init_const(int(im.group(1)))
        if ins.opcode in ("copy", "convert", "bitcast"):
            ops = _operand_names(ins)
            if ops:
                return value_in_cond(ops[0])
        if ins.opcode == "parameter":
            pm = re.search(r"parameter\((\d+)\)", ins.body)
            if pm:
                return init_const(int(pm.group(1)))
        return None

    def compare_sites():
        # compares directly in the condition, or inside fusions it calls
        for ins in cond.instrs:
            if ins.opcode == "compare":
                yield ins, value_in_cond
            elif ins.opcode == "fusion":
                fm = re.search(r"calls=%?([\w.\-]+)", ins.body)
                if not fm or fm.group(1) not in comps:
                    continue
                fused = comps[fm.group(1)]
                call_ops = _operand_names(ins)

                def resolve(name, fused=fused, call_ops=call_ops):
                    fi = fused.by_name.get(name)
                    if fi is not None and fi.opcode == "parameter":
                        pm = re.search(r"parameter\((\d+)\)", fi.body)
                        if pm and int(pm.group(1)) < len(call_ops):
                            return value_in_cond(call_ops[int(pm.group(1))])
                    if name in fused.constants:
                        return fused.constants[name]
                    return None

                for fins in fused.instrs:
                    if fins.opcode == "compare":
                        yield fins, resolve

    for ins, resolve in compare_sites():
        dm = re.search(r"direction=(\w+)", ins.body)
        direction = dm.group(1) if dm else "LT"
        ops = _operand_names(ins)
        vals = [resolve(n) for n in ops[:2]]
        if len(vals) == 2 and vals[0] is not None and vals[1] is not None:
            lo, hi = vals
            if direction in ("GT", "GE"):
                lo, hi = hi, lo
            trip = hi - lo + (1 if direction in ("LE", "GE") else 0)
            if trip >= 0:
                return trip
    return None


def _operand_shape_text(comp: Computation, name: str,
                        bindings: List[str]) -> str:
    """Result-type text of an operand (scheduled HLO has name-only
    operands): defining instruction, or the caller binding for params."""
    ins = comp.by_name.get(name)
    if ins is None:
        return ""
    if ins.opcode == "parameter":
        pm = re.search(r"parameter\((\d+)\)", ins.body)
        if pm and int(pm.group(1)) < len(bindings):
            return bindings[int(pm.group(1))]
    return ins.result_text


def _dot_flops(ins: Instruction, comp: Computation,
               bindings: List[str]) -> float:
    res = _shape_list(ins.result_text)
    if not res:
        return 0.0
    out_elems = 1
    for d in res[0][1]:
        out_elems *= d
    cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.body)
    ops = _operand_names(ins)
    if not ops:
        return 0.0
    lhs_shapes = _shape_list(_operand_shape_text(comp, ops[0], bindings))
    if not lhs_shapes:
        return 2.0 * out_elems          # unknown contraction: lower bound
    lhs_dims = lhs_shapes[0][1]
    contract = 1
    if cm:
        for idx in cm.group(1).split(","):
            if idx and int(idx) < len(lhs_dims):
                contract *= lhs_dims[int(idx)]
    return 2.0 * out_elems * contract


@dataclass
class HLOCost:
    flops: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    unresolved_loops: int = 0
    loops: List[Tuple[str, int]] = field(default_factory=list)
    # (total_bytes, op, result_shape, mult, op_name metadata) largest first
    top_collectives: List[Tuple[float, str, str, float, str]] = \
        field(default_factory=list)

    def finalize(self, keep: int = 12) -> "HLOCost":
        self.top_collectives.sort(reverse=True)
        self.top_collectives = self.top_collectives[:keep]
        return self


def analyze(hlo: str, default_trip: int = 1) -> HLOCost:
    comps, entry = parse_module(hlo)
    cost = HLOCost(coll_breakdown={op: 0.0 for op in COLLECTIVE_OPS})

    def visit(comp_name: str, mult: float, stack: tuple,
              bindings: List[str], in_fusion: bool) -> None:
        comp = comps.get(comp_name)
        if comp is None or comp_name in stack:
            return
        for ins in comp.instrs:
            op = ins.opcode
            if op == "while":
                bm = re.search(r"body=%?([\w.\-]+)", ins.body)
                trip = _resolve_trip(ins, comp, comps)
                if trip is None:
                    trip = default_trip
                    cost.unresolved_loops += 1
                cost.loops.append((ins.name, trip))
                if bm:
                    visit(bm.group(1), mult * max(trip, 0),
                          stack + (comp_name,), [ins.result_text], False)
                continue
            if op in ("fusion", "call"):
                key = "calls=" if op == "fusion" else "to_apply="
                fm = re.search(key + r"%?([\w.\-]+)", ins.body)
                if fm:
                    binds = [_operand_shape_text(comp, n, bindings)
                             for n in _operand_names(ins)]
                    visit(fm.group(1), mult, stack + (comp_name,), binds,
                          in_fusion or op == "fusion")
            elif op == "conditional" and "branch_computations={" in ins.body:
                brs = ins.body.split("branch_computations={")[1].split("}")[0]
                for br in re.findall(r"%([\w.\-]+)", brs):
                    visit(br, mult, stack + (comp_name,), [], in_fusion)
            if op in ("dot", "convolution"):
                cost.flops += mult * _dot_flops(ins, comp, bindings)
            if op in COLLECTIVE_OPS:
                b = _shape_bytes(ins.result_text)
                cost.coll_bytes += mult * b
                cost.coll_breakdown[op] += mult * b
                md = re.search(r'op_name="([^"]+)"', ins.body)
                cost.top_collectives.append(
                    (mult * b, op, ins.result_text[:48], mult,
                     (md.group(1) if md else "")[:90]))
            elif op == "parameter":
                if comp_name == entry:
                    cost.hbm_bytes += _shape_bytes(ins.result_text)
            elif op not in _SKIP_RESULT_OPS and not in_fusion:
                # fusion internals live in registers/VMEM; only top-level
                # results round-trip HBM (written once, read ~once)
                cost.hbm_bytes += 2.0 * mult * _shape_bytes(ins.result_text)
        return

    if entry:
        visit(entry, 1.0, (), [], False)
    return cost.finalize()
