#!/usr/bin/env python3
"""Count the SASS instructions of the softmax warp kernels, per element.

    python3 scripts/torch_softmax_sass.py

Builds the PyTorch port's kernels (``repro_torch.kernels.build``, which needs
``nvcc``), disassembles the library with ``cuobjdump -sass`` and, for the
warp kernels that the unfused path's rows take under HYFT16, prints one JSON
object per line: the static instructions by pipe along the path a warp takes
on a fast row, and per element of a row of ``cols`` columns (one warp a
row: 32 times the warp's instructions over ``cols``).

* ``softmax_fwd_warp_kernel<float, __half, 32>`` at 1024 columns (training)
  and ``<float, __half, 40>`` at 1057 (the prompt);
* ``softmax_bwd_warp_kernel<__half, __half, float, 32>`` (fp32 dz, as the
  training step stores it) and ``<__half, __half, __half, 32>`` (fp16 dz),
  both at 1024.

The path counted: the code before the first subroutine the kernel calls
(the backward's row off its fast range) up to its last EXIT; an if without
an else counted whole, an if with an else (a conditional forward branch to
code that an unconditional forward branch jumps over) by its shorter arm
(the forward's max at step 1, not its strided max); NOPs left out.  A
static count: a lane that predicates a padded chunk off still issues it.
These counts describe the build, not the function: they are no bound.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# opcodes by pipe (the base name before the first "."): the integer ALU, the
# integer multiply-add (on the FMA pipe), conversions
ALU = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR", "LEA",
       "IMNMX", "VIMNMX", "VIADDMNMX", "VIADD", "ISETP", "SEL", "PRMT", "IABS", "BMSK",
       "SGXT", "BREV", "FLO", "POPC", "ISCADD", "PLOP3", "P2R", "R2P"}
IMAD = {"IMAD", "IMUL", "IMADSP"}
CONV = {"I2F", "F2I", "F2F", "FRND", "F2FP", "I2I", "I2FP", "F2IP"}
# (kernel, its template arguments, columns of the row it takes)
ROWS = [("softmax_fwd_warp_kernel", "float, __half, 32", 1024),
        ("softmax_fwd_warp_kernel", "float, __half, 40", 1057),
        ("softmax_bwd_warp_kernel", "__half, __half, float, 32", 1024),
        ("softmax_bwd_warp_kernel", "__half, __half, __half, 32", 1024)]


def functions(library: str) -> dict:
    """{demangled name: [(address, opcode, unpredicated, branch target)]}."""
    from repro_torch.kernels import build
    tools = Path(build.nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", library], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    funcs, ops = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            ops = funcs.setdefault(head.group(1), [])
            continue
        op = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
                       r"(\S*\s+\S*)", line)
        if ops is not None and op and op.group(3) != "NOP":
            target = re.match(r"\S*\s+(0x[0-9a-f]+)", op.group(4))
            ops.append((int(op.group(1), 16), op.group(3), op.group(2) is None,
                        int(target.group(1), 16) if target and op.group(3) in ("CALL", "BRA")
                        else None))
    names = list(funcs)
    demangled = subprocess.run([str(tools / "cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    return {name: funcs[mangled] for mangled, name in zip(names, demangled)}


def fast_path(body: list) -> list:
    """The opcodes of ``body`` along a fast row's path (see the module note)."""
    end = min([t for _, o, _, t in body if o == "CALL"], default=None)
    last_exit = max(a for a, o, *_ in body if o == "EXIT" and (end is None or a < end))
    body = [x for x in body if x[0] <= last_exit]
    before = {b[0]: a for a, b in zip(body, body[1:])}   # address -> the instruction before
    skipped = []
    for a, o, always, t in body:
        if o != "BRA" or always or t is None or t <= a or t not in before:
            continue
        jump = before[t]                                   # the then arm's last instruction
        if jump[1] == "BRA" and jump[2] and jump[3] is not None and jump[3] > t:
            then = (a, jump[0] + 1)                        # (a, jump] holds the then arm
            other = (t - 1, jump[3])                       # [t, end of the else)
            arms = [sum(lo < x[0] < hi for x in body) for lo, hi in (then, other)]
            skipped.append(then if arms[0] > arms[1] else other)
    return [o for a, o, *_ in body if not any(lo < a < hi for lo, hi in skipped)]


def main():
    from repro_torch.kernels import build
    funcs = functions(build.build()["path"])
    for kernel, args, cols in ROWS:
        *types, per = [a.strip() for a in args.split(",")]
        pat = re.escape(f"{kernel}<{', '.join(types)}, ") + rf"(?:\(int\))?{per}>"
        found = [name for name in funcs if re.search(pat, name)]
        if len(found) != 1:
            raise SystemExit(f"{kernel}<{args}>: {len(found)} matches in the SASS")
        ops = fast_path(funcs[found[0]])
        counts = {"all": len(ops), "alu": sum(o in ALU for o in ops),
                  "imad": sum(o in IMAD for o in ops), "conv": sum(o in CONV for o in ops),
                  "fp": sum(o[0] in "FH" and o not in CONV for o in ops),
                  "uniform": sum(o[0] == "U" for o in ops)}
        print(json.dumps({"kernel": found[0], "cols": cols, "sass": counts,
                          **{f"{k}_per_element": 32 * v / cols for k, v in counts.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
