#!/usr/bin/env python3
"""Compare the SASS of the kernels in two builds of one CUDA library, e.g.
build/libfused_decode.so of this checkout and of a `git archive` of its
parent, to show that a refactor compiles to the same work.

    python3 scripts/sass_compare.py outputs/parent/build/libfused_decode.so \\
        build/libfused_decode.so

Kernels are paired by their kind (the last word of the kernel's name
before its template arguments: ..._narrow_kernel, ..._wide_kernel,
pack_kernel) and their integer and bool template arguments, so a kernel
that moved into a template on an input policy still meets its old self.
For each pair it prints one JSON line: the instruction counts, whether
the opcode sequences are equal, and how many opcodes differ (a diff of
the two sequences); register numbers and constant-bank offsets are not
compared.  Needs cuobjdump (the CUDA toolkit) on PATH or under
/usr/local/cuda/bin.

    python3 scripts/sass_compare.py --by-name --drop-false \
        outputs/parent/build/libfused_train.so build/libfused_train.so

--by-name pairs kernels by their own name (its anonymous namespace's
hash left out) instead of their kind; --drop-false leaves false bool
template arguments out of the key, so that an instance of a kernel that
lost a bool parameter meets its old false instance.
"""
from __future__ import annotations

import difflib
import json
import os
import re
import shutil
import subprocess
import sys


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise SystemExit(f"{name} not found")
    return path


def kernels(lib: str, by_name: bool = False, drop_false: bool = False):
    """{key: (mangled name, [opcode, ...])} of every kernel in lib."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, name, ops = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = ops
            name, ops = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name is not None:
            ops.append(m.group(1))
    out.pop("<end>", None)
    keyed = {}
    for raw, ops in out.items():
        m = re.search(r"(pack|narrow|wide)_kernel", raw)
        # Itanium template arguments: Li3E (int 3), Lb1E (bool true)
        args = [("true" if v == "1" else "false") if t == "b" else v
                for t, v in re.findall(r"L([ib])(-?\d+)E", raw)]
        if drop_false:
            args = [a for a in args if a != "false"]
        kind = (m.group(1) if m else raw) + "_kernel"
        named = re.search(r"([a-z][a-z_]*_kernel)", raw)
        if by_name and named:
            kind = named.group(1)
        keyed[f"{kind}<{','.join(args)}>"] = (raw, ops)
    return keyed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = {f: f in argv for f in ("--by-name", "--drop-false")}
    argv = [x for x in argv if x not in flags]
    if len(argv) != 2:
        print(__doc__)
        return 2
    a, b = (kernels(x, flags["--by-name"], flags["--drop-false"])
            for x in argv)
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            print(json.dumps({"kernel": key, "only_in": argv[0] if key in a
                              else argv[1]}))
            continue
        ops_a, ops_b = a[key][1], b[key][1]
        sm = difflib.SequenceMatcher(a=ops_a, b=ops_b, autojunk=False)
        differ = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2
                     in sm.get_opcodes() if tag != "equal")
        print(json.dumps({"kernel": key, "instructions": [len(ops_a),
                                                          len(ops_b)],
                          "opcodes_equal": ops_a == ops_b,
                          "opcodes_differing": differ}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
