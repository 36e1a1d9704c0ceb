#!/usr/bin/env python3
"""Compare the SASS of the port's attention kernels between two source trees.

    python3 scripts/torch_sass_compare.py --parent DIR [--tree DIR] [--width 128]

Builds the CUDA kernels of each tree (``repro_torch.kernels.build`` of that
tree, in a process of its own, into the tree's own ``build/``), disassembles
both libraries with ``cuobjdump -sass`` and, for every instantiation of the
flash kernels (``flash_fwd_kernel``, ``flash_bwd_dq_kernel``,
``flash_bwd_dkv_kernel``) and of the split-K kernels (``verify_kernel``,
``decode_kernel``) at head width ``--width`` in ``--tree``, finds the
parent's kernel of the same name (a parent whose split-K kernels take no
width template argument is matched with that argument left out) and says
whether the two instruction streams are identical (opcodes and operands;
addresses and encodings left out), whether their opcodes alone are, and
how many instructions differ.  Prints one JSON object per kernel and a
summary line; exits 1 if a kernel has no counterpart.  Identical SASS runs
in the same time and gives the same bits.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
           "verify_kernel", "decode_kernel")


def library(tree: Path) -> str:
    """Build ``tree``'s kernels in a fresh process; the library's path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; print(build.build()['path'])")
    out = subprocess.run([sys.executable, "-c", code, str(tree / "src")], check=True,
                         capture_output=True, text=True, timeout=1200).stdout
    return out.strip().splitlines()[-1]


def sass(lib: str) -> dict:
    """{demangled kernel name: [instruction text]} of one library."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    tools = Path(build.nvcc()).parent
    text = subprocess.run([str(tools / "cuobjdump"), "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    funcs, body = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            body = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if body is not None and ins:
            body.append(ins.group(1))
    names = list(funcs)
    demangled = subprocess.run([str(tools / "cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    return {name: funcs[mangled] for mangled, name in zip(names, demangled)}


def base_name(name: str) -> str:
    """``void hyft_attend::<unnamed>::verify_kernel<float, (int)64,
    (bool)0>(const float *, ...)`` -> ``verify_kernel<float, 64, 0>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\((int|bool)\)", "", re.sub(r"^void\s+", "", name))
    return name.split("(")[0].split("::")[-1].strip()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--tree", type=Path, default=ROOT)
    p.add_argument("--width", type=int, default=128)
    args = p.parse_args()
    new = {base_name(n): b for n, b in sass(library(args.tree.resolve())).items()}
    old = {base_name(n): b for n, b in sass(library(args.parent.resolve())).items()}
    print(json.dumps({"kernels_in_tree": len(new), "kernels_in_parent": len(old),
                      "examples": sorted(new)[:3]}), flush=True)
    w = args.width
    same = differ = missing = 0
    for name in sorted(new):
        parts = re.fullmatch(r"(\w+)<(.*)>", name)
        if parts is None or parts.group(1) not in KERNELS:
            continue
        kernel = parts.group(1)
        targs = [a.strip() for a in parts.group(2).split(",")]
        if len(targs) < 2 or int(re.sub(r"\D", "", targs[1]) or -1) != w:
            continue
        # the parent's split-K kernels had no width argument: <KV, PS, paged>
        candidates = [name, f"{kernel}<{', '.join([targs[0]] + targs[2:])}>"]
        match = next((c for c in candidates if c in old), None)
        rec = {"kernel": name, "parent": match, "instructions": len(new[name])}
        if match is None:
            missing += 1
        else:
            a, b = old[match], new[name]
            rec["parent_instructions"] = len(a)
            rec["identical"] = a == b
            # the opcodes alone (registers and operands left out), and the
            # instructions that differ at all
            rec["same_opcodes"] = [x.split()[0] for x in a] == [x.split()[0] for x in b]
            rec["differing_instructions"] = sum(x != y for x, y in zip(a, b)) + abs(
                len(a) - len(b))
            if rec["identical"]:
                same += 1
            else:
                differ += 1
        print(json.dumps(rec), flush=True)
    print(json.dumps({"width": w, "identical": same, "different": differ,
                      "without_parent": missing}), flush=True)
    if missing:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
