#!/usr/bin/env python3
r"""Compare the machine code of the kernels in two builds of the port's
kernel library.

    python3 tools/sass_compare.py OLD.so NEW.so [--match REGEX]
        [--old-sub PATTERN REPL]

Dumps each library's SASS with ``cuobjdump -sass`` (from the CUDA toolkit
beside ``nvcc``) and compares it kernel by kernel, after stripping what
differs between two builds of the same code: the hash nvcc gives each
file's anonymous namespace (part of every kernel's mangled name), the
instruction addresses in comments and the column padding, which follows the
widest instruction in the library.  Prints ``same`` or ``DIFF`` and the
instruction count for each kernel whose name ``--match`` (a regular
expression) finds, and exits 1 if any differs or is missing from NEW.
``--old-sub`` rewrites OLD's names first (``re.sub``), for a kernel whose
mangled name changed with its signature: the SSD block's f32 kernels lost
their element-type template parameter (always float), so

    --match 'ssd_(y|state)_kernel.*ArgsIfE' \
    --old-sub 'ILi(\d+)EfEEvNS_4ArgsIT0_EE' 'ILi\1EEEvNS_4ArgsIfEE'

holds each new f32 instance to the old one of the same head_dim (the
match applies to the rewritten names).  Use it
to show that moving code between files left a kernel's instructions as
they were.
"""
import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
ENCODING = re.compile(r"/\*[0-9a-f]{4,}\*/")
# cuobjdump pads each listing's columns to its widest instruction
SPACES = re.compile(r"\s+")


def cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit("cuobjdump not found (it comes with the CUDA toolkit)")


def kernels(path):
    """Kernel name (namespace hash stripped) -> its SASS lines."""
    out = subprocess.run([cuobjdump(), "-sass", str(path)], check=True,
                         capture_output=True, text=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = ANON.sub("ANON", line.split("Function :")[1].strip())
            found[name] = []
        elif name is not None and line.strip():
            line = SPACES.sub(" ", ENCODING.sub("", line))
            found[name].append(line.strip())
    return found


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--match", default="",
                    help="compare only kernels whose name this regular "
                         "expression finds")
    ap.add_argument("--old-sub", nargs=2, metavar=("PATTERN", "REPL"),
                    help="rewrite OLD's kernel names with re.sub first")
    args = ap.parse_args()
    old, new = kernels(args.old), kernels(args.new)
    if args.old_sub:
        old = {re.sub(*args.old_sub, n): v for n, v in old.items()}
    differ = 0
    for name in sorted(n for n in old if re.search(args.match, n)):
        same = old[name] == new.get(name)
        differ += not same
        print(f"{'same' if same else 'DIFF' if name in new else 'MISSING'} "
              f"{len(old[name]):6d} {name}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
