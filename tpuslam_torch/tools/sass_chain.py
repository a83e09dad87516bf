"""The dependent chain of one step of a loop in a kernel's SASS: the
least time a step can take, whatever the card does beside it.

    python -m tpuslam_torch.tools.sass_chain FILE.sass --function NAME
        --marker OPCODE [--index I] [--exclude OPCODE] [--rare TEXT]
        [--per N] [--clock-mhz MHZ] [--show]

Reads `cuobjdump -sass` output, takes the function whose name contains
NAME, and in it, of the loops whose bodies hold the most instructions
of opcode MARKER and none of opcode EXCLUDE, the I-th by address
(MUFU.RSQ picks K7's factor chain; STG without LDGSTS, index 0 and -1,
its columns' forward and backward loops).  It walks the body once as
one lane runs it on its fast path: a conditional forward branch over a
slow-path call (a call within a few instructions) is taken, and so is
the innermost one around an instruction whose operands hold TEXT (a
rare path inline: K7's div_small, marked by its 2^100 scaling), any
other conditional forward branch falls through (a wait on a barrier
that ptxas placed out of line, after the exits, succeeds at once), an
unconditional one jumps, a branch back inside the body (a spin) falls
through.  Each instruction's results are ready its latency after its
last operand (registers, predicates, uniform registers, a predicated
write's old value; a shared-memory load after the last shared-memory
store); the chain is the latest result, divided by N when the body
holds N unrolled steps.  Latencies (cycles, the model's assumptions,
chosen low so that the chain stays a least time): 4 for the arithmetic
and logic units, 14 for MUFU, 20 for shared-memory loads and shuffles,
24 for local-memory loads (an L1 hit), and 0 for barriers and branches;
global loads are prefetches in K7 and their results are not waited on
inside a step.  The model issues any number of instructions a cycle:
the compiled schedule's own stalls (the control bits) can only add.
With --clock-mhz the chain is also printed in ns at that clock.
"""

from __future__ import annotations

import argparse
import re
import sys

FIXED = 4
SLOW_PATH = 6          # a fast path's branch skips a call in this many
LATENCY = {"MUFU": 14, "LDS": 20, "SHFL": 20, "LDL": 24}
NO_WAIT = ("LDG", "STG", "STS", "STL", "BAR", "BSSY", "BSYNC", "WARPSYNC",
           "NOP", "BRA", "CALL", "EXIT", "RET", "SYNCS", "LDGSTS",
           "LDGDEPBAR", "DEPBAR", "MEMBAR", "FENCE", "ERRBAR", "CCTL",
           "YIELD", "NANOSLEEP")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)"
                  r"\s*([^;]*);")
REG = re.compile(r"\b(U?R(?:Z|\d+)|U?P(?:T|\d+))\b")


def functions(text):
    """{name: [(address, predicate, opcode, operands)]} of a SASS file."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4)))
    return out


def _target(ops):
    m = re.search(r"0x([0-9a-f]+)", ops)
    return int(m.group(1), 16) if m else None


def loops(insns):
    """(head, end) address ranges of the loops: conditional backward
    branches with no exit in between (an unconditional one returns from
    code placed out of line, after the function's exits)."""
    exits = [a for a, _, op, _ in insns if op.startswith("EXIT")]
    return [(_target(ops), a) for a, pred, op, ops in insns
            if op == "BRA" and pred and _target(ops) is not None and
            _target(ops) < a and
            not any(_target(ops) <= e <= a for e in exits)]


def outermost(insns, marker, index=0, exclude=None):
    """Of the loops whose bodies hold the most `marker` instructions (and
    no `exclude` instruction), the index-th by address."""
    def count(lo, hi, op_):
        return sum(1 for a, _, op, _ in insns if lo <= a <= hi and
                   op.startswith(op_))
    found = [r for r in loops(insns)
             if exclude is None or not count(*r, exclude)]
    most = max(count(*r, marker) for r in found)
    return sorted(r for r in found if count(*r, marker) == most)[index]


def _regs(text):
    return [r for r in REG.findall(text) if r not in ("RZ", "URZ", "PT")]


def _guards(insns, a, t, rare):
    """Whether the conditional branch at a, over (a, t), is the innermost
    one around an instruction whose operands hold `rare`."""
    over = [x for x in insns if a < x[0] < t]
    marked = [x[0] for x in over if rare in x[3]]
    if not marked:
        return False
    return not any(op == "BRA" and pred and _target(ops) is not None and
                   b < m < _target(ops) for b, pred, op, ops in over
                   for m in marked)


def walk(insns, lo, hi, rare=None):
    """The instructions one lane runs through the body [lo, hi] on its
    fast path, in order; with `rare`, the innermost conditional branch
    around an instruction whose operands hold it is taken too (a rare
    path inline)."""
    at = {a: i for i, (a, _, _, _) in enumerate(insns)}
    i, path = at[lo], []
    while i < len(insns) and insns[i][0] < hi:
        a, pred, op, ops = insns[i]
        path.append(insns[i])
        if op == "BRA":
            t = _target(ops)
            if t is not None and a < t <= hi:
                over = [x for x in insns if a < x[0] < t]
                if not pred or (len(over) <= SLOW_PATH and any(
                        x[2].startswith("CALL") for x in over)) or (
                        rare and _guards(insns, a, t, rare)):
                    i = at[t]
                    continue
        i += 1
    return path


def chain(path):
    """(the latest result's cycle, per-instruction ready cycles)."""
    ready, last_sts, times = {}, 0, []
    for a, pred, op, ops in path:
        base = op.split(".")[0]
        parts = [p.strip() for p in ops.split(",")]
        writes_first = base not in NO_WAIT and not base.startswith("ST") \
            and parts and _regs(parts[0])
        dst = _regs(parts[0]) if writes_first else []
        if base in ("FSETP", "ISETP", "DSETP", "HSETP2", "PLOP3", "FCHK"):
            dst = [r for r in _regs(",".join(parts[:2])) if "P" in r]
        # a predicated write keeps the old value where the predicate is
        # false, so that value is an operand too
        srcs = _regs(pred) + [r for r in _regs(",".join(parts))
                              if r not in dst or pred]
        start = max([ready.get(r, 0) for r in srcs] + [0])
        if base == "LDS":
            start = max(start, last_sts)
        if base in NO_WAIT or base.startswith("ST"):
            if base == "STS":
                last_sts = start
            times.append((a, op, start))
            continue
        done = start + LATENCY.get(base, FIXED)
        for r in dst:
            ready[r] = done
            if r.startswith("R") and r[1:].isdigit() and \
                    op.endswith((".64", ".WIDE", ".128")):
                width = 4 if op.endswith(".128") else 2
                for k in range(1, width):
                    ready[f"R{int(r[1:]) + k}"] = done
        times.append((a, op, done))
    return max([t for _, _, t in times] + [0]), times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass")
    ap.add_argument("--function", required=True)
    ap.add_argument("--marker", required=True)
    ap.add_argument("--per", type=int, default=1,
                    help="unrolled steps in the loop's body")
    ap.add_argument("--index", type=int, default=0,
                    help="of the loops with the most markers, this one")
    ap.add_argument("--exclude", help="skip the loops holding this opcode")
    ap.add_argument("--rare", help="an operand text only a rare inline "
                    "path holds: the branch around it is taken")
    ap.add_argument("--clock-mhz", type=float)
    ap.add_argument("--show", action="store_true",
                    help="print each instruction's ready cycle")
    args = ap.parse_args(argv)
    with open(args.sass) as f:
        funcs = functions(f.read())
    name = next(k for k in funcs if args.function in k)
    insns = funcs[name]
    lo, hi = outermost(insns, args.marker, args.index, args.exclude)
    path = walk(insns, lo, hi, args.rare)
    cycles, times = chain(path)
    if args.show:
        for a, op, t in times:
            print(f"{a:06x} {op:24s} {t}")
    per = cycles / args.per
    line = (f"{name}: loop {lo:#x}-{hi:#x}, {len(path)} instructions on "
            f"the path, chain {cycles} cycles, {per:.1f} per step")
    if args.clock_mhz:
        line += f", {per * 1e3 / args.clock_mhz:.1f} ns at " \
                f"{args.clock_mhz:g} MHz"
    print(line)
    return per


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
