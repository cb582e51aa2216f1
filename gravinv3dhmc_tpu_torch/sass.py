"""Read the SASS of a built kernel library and count its issued
instructions, for the bounds of the kernels whose work is not f32 FLOP.

``cuobjdump -sass`` of a library (:func:`functions`, :func:`parse`) is
split into its kernel functions; :func:`path` walks one thread's fast
path through a function and :func:`counts` sorts its instructions into
the arithmetic pipe classes of :data:`ARITHMETIC`. :func:`unit_counts`
gives, from the libraries as built, the instructions of one unit of work
of each such kernel (four momentum normals, one accept uniform, one node
value of the gz matrix), and :func:`instruction_seconds` the least time
the card takes to issue them. ``chip_smoke.py`` bounds ``draws``, ``refresh``, ``gz``
and ``gz_nodes`` with them; ``gz_tune.py`` prints them beside another
commit's.
"""
from __future__ import annotations

import os
import re
import subprocess

#: the arithmetic classes of SASS opcodes, by the pipe that executes
#: them: FP32 adds, multiplies and multiply-adds on the two FMA pipes (128
#: lanes an SM a clock), integer multiply-adds on one of them (64), the
#: ALU's integer, logic and FP32 compare and select (64), MUFU and
#: conversions (16). Every other opcode (moves, and an ``IMAD`` used as
#: one, branches, convergence barriers, memory, the uniform datapath) is
#: counted under its own name and left out of a bound, which so stays a
#: lower bound whichever branch the data take.
ARITHMETIC = {
    "fma": {"FFMA", "FADD", "FMUL", "HFMA2", "FMUL32I", "FADD32I",
            "FFMA32I"},
    "imad": {"IMAD", "IMUL"},
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "LEA", "SEL", "PRMT",
            "IABS", "FSETP", "FSEL", "FMNMX", "FCHK", "VIADD", "VIMNMX",
            "VIADDMNMX", "PLOP3", "FSET", "P2R", "R2P", "POPC", "FLO",
            "BREV", "BMSK", "SGXT"},
    "mufu_conv": {"MUFU", "I2FP", "I2F", "F2I", "F2F", "FRND", "F2IP"},
}
#: the card's SMs and the clock behind its 67 TFLOP/s f32 peak (NVIDIA H100
#: SXM: 132 SMs x 128 lanes x 2 FLOP x 1.98 GHz)
SMS, CLOCK_HZ = 132, 1.98e9

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_class(opcode, modifiers="", operands=""):
    """The arithmetic class of a SASS instruction, or its opcode; ``MOV``
    for an ``IMAD`` that moves (``IMAD.MOV``, or RZ times RZ plus a value),
    which the compiler issues on the FMA pipe to spare the ALU."""
    if opcode == "IMAD" and (modifiers.startswith(".MOV") or re.match(
            r"[^,]+,\s*RZ,\s*RZ,", operands)):
        return "MOV"
    for name, ops in ARITHMETIC.items():
        if opcode in ops:
            return name
    return opcode


def functions(lib):
    """``(text, parse(text))`` of ``cuobjdump -sass`` of the library (a
    ``KernelLibrary``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib.path)],
        capture_output=True, text=True, timeout=120, check=True).stdout
    return text, parse(text)


def parse(text):
    """``{function name: (instructions, labels)}`` of ``cuobjdump -sass``
    output: instructions as (address, predicate, opcode, modifiers,
    operands), NOPs left out; labels name -> address."""
    fns, fn, pending = {}, None, []
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            fns[fn] = ([], {})
            continue
        if fn is None:
            continue
        label = _LABEL.match(ln)
        if label:
            pending.append(label.group(1))
            continue
        m = _LINE.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                fns[fn][1][name] = addr
            pending = []
            if m.group(3) != "NOP":
                fns[fn][0].append((addr, (m.group(2) or "").strip(),
                                   m.group(3), m.group(4),
                                   m.group(5).strip()))
    return fns


def find(fns, short):
    """The (instructions, labels) of the kernel named ``short`` in
    :func:`parse`'s dict (a kernel of a source's anonymous namespace:
    its mangled name holds the name's length, the name and ``E``);
    KeyError unless exactly one is there."""
    pat = re.compile(rf"{len(short)}{short}E")
    hits = [v for k, v in fns.items() if pat.search(k)]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} SASS functions named {short}")
    return hits[0]


def _target(operands, labels):
    label = re.search(r"(\.L_x_\d+)", operands)
    addr = re.search(r"0x([0-9a-f]+)", operands)
    return (labels.get(label.group(1)) if label else
            int(addr.group(1), 16) if addr else None)


def path(instrs, labels, skip_slow, start=0, stop=None):
    """The (opcode, modifiers, operands) one thread issues from
    instruction ``start`` (the function's entry) to its first
    unpredicated EXIT or to instruction ``stop`` (a revisited instruction
    also ends it), every unconditional BRA followed. A conditional
    branch is not taken, except with ``skip_slow`` a forward one over a
    slow path: a region with a DMUL, a CALL or a loop (sincosf's
    large-argument reduction, the slow paths of IEEE division and square
    root) and no MUFU.RSQ (a whole normal or corner term, which holds one
    square root)."""
    at = {a: i for i, (a, *_) in enumerate(instrs)}
    out, seen, i = [], set(), start
    while 0 <= i < len(instrs) and i not in seen:
        seen.add(i)
        _, pred, op, mods, operands = instrs[i]
        out.append((op, mods, operands))
        if (op == "EXIT" and not pred) or i == stop:
            break
        if op == "BRA":
            t = at.get(_target(operands, labels))
            if not pred:
                i = len(instrs) if t is None else t
                continue
            if skip_slow and t is not None and t > i:
                region = instrs[i + 1:t]
                slow = any(o in ("DMUL", "CALL") or (
                    o == "BRA" and at.get(_target(x, labels), t) <= i)
                    for _, _, o, _, x in region)
                rsq = any(o == "MUFU" and m.startswith(".RSQ")
                          for _, _, o, m, _ in region)
                if slow and not rsq:
                    i = t
                    continue
        i += 1
    return out


def loop_pass(instrs, labels):
    """The fast path (:func:`path` with ``skip_slow``) of one pass of the
    function's outermost loop: from the head of its backward branch that
    reaches furthest back to that branch."""
    at = {a: i for i, (a, *_) in enumerate(instrs)}
    backs = [(at[t], i) for i, (_, _, op, _, x) in enumerate(instrs)
             if op == "BRA" and (t := _target(x, labels)) in at
             and at[t] <= i]
    if not backs:
        raise KeyError("no loop in the function")
    head, back = min(backs)
    return path(instrs, labels, True, start=head, stop=back)


def corner_segments(steps):
    """A path cut at each MUFU.RSQ (one a corner term): the segments
    between the first and the last, one corner term each."""
    cuts = [k for k, (op, mods, _) in enumerate(steps)
            if op == "MUFU" and mods.startswith(".RSQ")]
    return [steps[a:b] for a, b in zip(cuts, cuts[1:])]


def counts(steps, per=1):
    """Issued instructions of a path by class (:func:`sass_class`),
    divided by ``per``."""
    out = {}
    for step in steps:
        c = sass_class(*step)
        out[c] = out.get(c, 0) + 1
    return {c: round(n / per, 2) for c, n in sorted(out.items())}


def arithmetic(c):
    """The arithmetic classes of a :func:`counts` dict."""
    return {k: v for k, v in c.items() if k in ARITHMETIC}


def unit_counts(leapfrog, prism_gz):
    """Issued instructions by class (:func:`counts`, every class) of one
    unit of work, from the SASS of the two libraries as built:

    - ``normal4``: four momentum normals (``momentum4``: one
      Philox4x32-10 and two Box-Muller), one pass of
      ``momentum4_loop_kernel``'s loop (:func:`loop_pass`; sincosf's
      large-argument and sqrtf's slow paths skipped): the key schedule,
      the same for every counter, stays before the loop, and the pass
      holds the loop's own counter, compare, branch and store;
    - ``uniform``: one accept uniform (``accept_uniform``: one
      Philox4x32-10 and its u24), ``accept_uniform_once_kernel``'s;
    - ``node``: one node value of the gz matrix (``nagy_term``: 3
      squares, sqrtf, 2 guarded logs with a division, the guarded atan2
      with its division, the term), the mean corner term on
      ``gz_kernel``'s fall-through less the corner sum's one FADD, which
      the node form does per entry.

    The two probe kernels hold nothing but their function, its parameter
    loads and its stores."""
    _, lf = functions(leapfrog)
    _, gz = functions(prism_gz)
    out = {"normal4": counts(loop_pass(*find(lf, "momentum4_loop_kernel"))),
           "uniform": counts(path(*find(lf, "accept_uniform_once_kernel"),
                                  True))}
    segs = corner_segments(path(*find(gz, "gz_kernel"), False))
    node = counts([x for seg in segs for x in seg], len(segs))
    node["fma"] = round(node.get("fma", 0) - 1, 2)
    out["node"] = node
    return out


def scaled(*terms, **extra):
    """The arithmetic instructions of ``terms``, (per unit, units) pairs
    (a per-unit :func:`counts` dict times its number of units), summed,
    plus ``extra`` (class -> count)."""
    out = dict(extra)
    for per_unit, units in terms:
        for k, v in arithmetic(per_unit).items():
            out[k] = out.get(k, 0) + v * units
    return out


def instruction_seconds(c):
    """The least time the card takes to issue the arithmetic instructions
    ``c`` (class -> count): the slowest of their issue (128 lanes an SM a
    clock: 4 schedulers x 32) and of each pipe (the CUDA C++ Programming
    Guide's arithmetic-instruction throughput for compute capability 9.0:
    the two FMA pipes 128 lanes, integer multiply-adds on one of them 64,
    the ALU 64, MUFU and conversions 16)."""
    c = arithmetic(c)
    lanes = SMS * CLOCK_HZ
    fma, imad = c.get("fma", 0), c.get("imad", 0)
    return max(sum(c.values()) / (128 * lanes),
               (fma + imad) / (128 * lanes), imad / (64 * lanes),
               c.get("alu", 0) / (64 * lanes),
               c.get("mufu_conv", 0) / (16 * lanes))
