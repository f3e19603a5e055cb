"""Compare the machine code (SASS) of this checkout's CUDA kernels with
another checkout's, function by function.

  python -m repro_torch.kernels.sass --against OTHER_CHECKOUT

Builds both checkouts' kernel libraries (each with its own ``build.py``,
in a subprocess, into its own ``build/``), disassembles them with
``cuobjdump -sass``, and prints, for every function of the serving
instantiations (``fa_fwd_tc<HD, false>``, ``fa_fwd<HD, false>``,
``scan_fwd<DS, false>``, ``dec_split``, ``dec_fwd``), whether its SASS is
the same in both (instruction text and encoding; the anonymous
namespace's per-file hash taken out of the names, and the column padding
out of the lines); then the HGMMA (wgmma) and total instruction counts of
each of this checkout's flash-backward functions (``fa_bwd_d*``).  Exits
non-zero if a serving function differs or is missing.  Needs nvcc and
cuobjdump: it runs on the machine with the card, not in the CPU tests.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[3]
SERVING = (r"fa_fwd_tcILi\d+ELb0E", r"fa_fwdILi\d+ELb0E",
           r"scan_fwdILi\d+ELb0E", r"dec_split", r"dec_fwd")
# the functions whose HGMMA instructions are counted: the flash backward's
BWD = "fa_bwd_d"
# _ZN<len>_GLOBAL__N__<hash>_<len>_<file>_cu_<hash>: differs by source text
_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def library(checkout: Path) -> Path:
    """Build (or reuse) the kernel library of a checkout."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'src');"
         "from repro_torch.kernels import build; print(build.library_path())"],
        cwd=checkout, capture_output=True, text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path) -> Dict[str, List[str]]:
    """name (anonymous namespace removed) -> its SASS instruction lines."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = _ANON.sub("", line.split("Function :")[1].strip())
            funcs[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            # cuobjdump pads its columns by the names in the file
            funcs[name].append(" ".join(_ANON.sub("", line).split()))
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True, type=Path,
                    help="the other checkout's root")
    args = ap.parse_args(argv)
    mine = functions(library(HERE))
    theirs = functions(library(args.against.resolve()))
    bad = 0
    for pattern in SERVING:
        names = sorted(n for n in mine if re.search(pattern, n))
        if not names:
            print(f"no function matches {pattern}")
            bad += 1
        for n in names:
            same = theirs.get(n) == mine[n]
            bad += not same
            print(f"{'same' if same else 'DIFFERS'}: {n} "
                  f"({len(mine[n])} instructions)")
            if not same:
                other = theirs.get(n, [])
                print(f"  the other's: {len(other)} instructions")
                diff = [(a, b) for a, b in zip(other, mine[n]) if a != b]
                for a, b in diff[:3]:
                    print(f"  - {a}\n  + {b}")
    for n in sorted(n for n in mine if BWD in n):
        hgmma = sum("HGMMA" in line for line in mine[n])
        print(f"HGMMA x{hgmma} of {len(mine[n])} instructions: {n}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
