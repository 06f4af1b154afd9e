"""The loops of a kernel in SASS, to count the instructions of a hot loop.

    python3 tools/sass_loops.py FILE.sass [NAME] [--blocks]

``FILE.sass`` is the output of ``cuobjdump -sass`` on a built library or
cubin (on a machine with the CUDA toolkit). For every function whose
mangled name contains ``NAME`` (default ``pf_kernel``) it builds the
control-flow graph, finds the natural loops (a back edge to a block that
dominates it) and prints, for each loop that holds the SplitMix32
multipliers (``mix`` in ``odelib_tpu_torch/ops/csrc/common.cuh``) and no
inner loop that does (in the particle filter: the Euler-Maruyama step
loop, once for the initial filter and once for the proposals'):

- its static size and a histogram of opcode classes;
- ``plain``: the fewest instructions from the loop's head around to it
  again, a step that takes no new noise pair and weighs nothing;
- ``draw``: the same through a block that hashes, a step that draws a
  noise pair for every particle the lane holds.

Both paths leave out the blocks that touch shared memory, shuffle, vote or
wait at a barrier (the weighing and resampling after an observed grid
point) and take every fast path (the libm functions' slow paths and
special cases are longer, and the shortest path avoids them). With one
state, steps alternate between ``draw`` and ``plain``, so an ordinary
step costs their mean, and a particle-step that mean over the particles a
lane holds. ``--blocks`` lists the loop's basic blocks.
"""
import heapq
import re
import sys
from collections import Counter

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
FUNC = re.compile(r"Function\s*:\s*(\S+)")
TARGET = re.compile(r"0x([0-9a-f]+)")
# SplitMix32's multipliers, as cuobjdump prints them (unsigned or signed)
MIX = ("0x85ebca6b", "-0x7a143595", "0xc2b2ae35", "-0x3d4d51cb")
# opcodes of the weighing and resampling, left out of the step paths
RESAMPLE = ("SHFL", "BAR", "VOTE", "LDS", "STS", "WARPSYNC")
CLASSES = (("MUFU", "mufu"), ("SHFL", "shfl"), ("BAR", "barrier"),
           ("LDS", "shared"), ("STS", "shared"), ("LDG", "global"),
           ("STG", "global"), ("LDC", "const"), ("F", "float"),
           ("I", "int"), ("LOP", "int"), ("SHF", "int"), ("LEA", "int"),
           ("BRA", "branch"), ("BSSY", "branch"), ("BSYNC", "branch"),
           ("CALL", "branch"), ("RET", "branch"), ("EXIT", "branch"),
           ("VOTE", "vote"), ("WARPSYNC", "sync"), ("NOP", "nop"))


def split(text):
    """(predicated, opcode, operands) of one instruction."""
    parts = text.split(None, 1)
    pred = parts[0].startswith("@")
    if pred:
        parts = parts[1].split(None, 1)
    return (pred and not parts[0].startswith("@PT"), parts[0],
            parts[1] if len(parts) > 1 else "")


def klass(op):
    for prefix, name in CLASSES:
        if op.startswith(prefix):
            return name
    return "other"


def functions(text):
    """{name: [(address, text), ...]} in the order cuobjdump prints."""
    out, name = {}, None
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSN.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def cfg(insns):
    """Basic blocks {start: [(address, text), ...]} and successors."""
    leaders = {insns[0][0]}
    for i, (addr, text) in enumerate(insns):
        _, op, rest = split(text)
        if op.startswith(("BRA", "BRX", "EXIT", "RET", "JMP")):
            if i + 1 < len(insns):
                leaders.add(insns[i + 1][0])
            m = TARGET.search(rest)
            if op.startswith("BRA") and m:
                leaders.add(int(m.group(1), 16))
    blocks, cur = {}, None
    for addr, text in insns:
        if addr in leaders:
            cur = addr
            blocks[cur] = []
        blocks[cur].append((addr, text))
    starts = sorted(blocks)
    succ = {}
    for i, b in enumerate(starts):
        pred, op, rest = split(blocks[b][-1][1])
        nxt = starts[i + 1] if i + 1 < len(starts) else None
        out = []
        if op.startswith("BRA"):
            m = TARGET.search(rest)
            if m and int(m.group(1), 16) in blocks:
                out.append(int(m.group(1), 16))
            if pred or ".DIV" in op:
                out.append(nxt)
        elif op.startswith(("EXIT", "RET", "BRX", "JMP")):
            if pred:
                out.append(nxt)
        else:
            out.append(nxt)
        succ[b] = [s for s in out if s is not None]
    return blocks, succ


def dominators(entry, succ):
    nodes = list(succ)
    preds = {n: [] for n in nodes}
    for n, ss in succ.items():
        for s in ss:
            preds[s].append(n)
    dom = {n: set(nodes) for n in nodes}
    dom[entry] = {entry}
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n == entry:
                continue
            ps = [dom[p] for p in preds[n]]
            new = (set.intersection(*ps) if ps else set()) | {n}
            if new != dom[n]:
                dom[n], changed = new, True
    return dom, preds


def natural_loops(entry, succ):
    """{head: (body blocks, latches)} of the back edges u -> head."""
    dom, preds = dominators(entry, succ)
    loops = {}
    for u, ss in succ.items():
        for h in ss:
            if h in dom[u]:
                body, latches = loops.setdefault(h, ({h}, set()))
                latches.add(u)
                stack = [u]
                while stack:
                    n = stack.pop()
                    if n not in body:
                        body.add(n)
                        stack.extend(preds[n])
    return loops


def shortest(blocks, succ, allowed, src, dst_set):
    """Fewest instructions on a path src -> one of dst_set inside
    ``allowed`` (both ends counted); {dst: cost}."""
    size = {b: len(blocks[b]) for b in allowed}
    best, heap, out = {src: size[src]}, [(size[src], src)], {}
    while heap:
        d, n = heapq.heappop(heap)
        if d > best.get(n, 1e18):
            continue
        if n in dst_set:
            out.setdefault(n, d)
        for s in succ[n]:
            if s in allowed and d + size[s] < best.get(s, 1e18):
                best[s] = d + size[s]
                heapq.heappush(heap, (best[s], s))
    return out


def cycle(blocks, succ, body, head, latches, via=None):
    """Fewest instructions around the loop from ``head`` back to it (through
    one of the blocks ``via``, if given)."""
    if via is None:
        d = shortest(blocks, succ, body, head, latches)
        return min(d.values()) if d else None
    best = None
    to_m = shortest(blocks, succ, body, head, via)
    for m, dm in to_m.items():
        back = shortest(blocks, succ, body, m, latches)
        if back:
            cost = dm + min(back.values()) - len(blocks[m])
            best = cost if best is None or cost < best else best
    return best


def report(path, name="pf_kernel", show_blocks=False):
    for fname, insns in functions(open(path).read()).items():
        if name not in fname or not insns:
            continue
        blocks, succ = cfg(insns)
        loops = natural_loops(insns[0][0], succ)
        hashes = {b for b, body in blocks.items()
                  if any(c in t for _, t in body for c in MIX)}
        rng = {h: lp for h, lp in loops.items() if lp[0] & hashes}
        inner = {h: lp for h, lp in rng.items() if not any(
            o != h and o in lp[0] and rng[o][0] < lp[0] for o in rng)}
        print(f"{fname}: {len(insns)} instructions, {len(blocks)} blocks, "
              f"{len(loops)} loops")
        for h, (body, latches) in sorted(inner.items()):
            body_insns = [x for b in body for x in blocks[b]]
            hist = Counter(klass(split(t)[1]) for _, t in body_insns)
            plain = {b for b in body if not any(
                split(t)[1].startswith(RESAMPLE) for _, t in blocks[b])}
            print(f"  step loop at {h:#06x}: {len(body)} blocks, "
                  f"{len(body_insns)} instructions; " + ", ".join(
                      f"{k} {v}" for k, v in sorted(hist.items())))
            print(f"    plain {cycle(blocks, succ, plain, h, latches)}, "
                  f"draw {cycle(blocks, succ, plain, h, latches, hashes & plain)}"
                  " instructions")
            if show_blocks:
                for b in sorted(body):
                    print(f"    block {b:#06x}: {len(blocks[b]):4d} "
                          f"instructions -> "
                          + " ".join(f"{s:#06x}" for s in succ[b])
                          + ("  hash" if b in hashes else "")
                          + ("" if b in plain else "  resample"))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        sys.exit(__doc__)
    report(args[0], *(args[1:2]), show_blocks="--blocks" in sys.argv)
