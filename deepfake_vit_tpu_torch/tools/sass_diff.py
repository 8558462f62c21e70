"""Compare the compiled kernels of two checkouts, kernel by kernel: registers,
spill bytes and SASS instructions.

    python3 deepfake_vit_tpu_torch/tools/sass_diff.py OLD_ROOT NEW_ROOT

Each root is a directory that holds a checkout's ``deepfake_vit_tpu_torch``
package (an earlier commit unpacked with ``git archive`` into an ignored
directory, and ``.`` for this one). Each builds its ``csrc/`` with its own
``ops/cuda_build.py`` (``-Xptxas -v``), into its own ``build/`` directory;
``cuobjdump -sass`` then disassembles both libraries. Kernels are paired by
their demangled names, so that the anonymous namespace's per-file tag does
not count. Prints one line a kernel: "same SASS", "DIFFERS" with the first
differing instructions, "gone" or "new", each with (registers, spills)
before and after. A refactor that should change no machine code is checked
by this, with no timing. Needs ``nvcc``, ``cuobjdump`` and ``cu++filt``
(the CUDA toolkit), not a card.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from pathlib import Path

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from deepfake_vit_tpu_torch.ops import cuda_build as c; "
         "print(c.build_library(verbose=True))")


def _tool(name: str) -> str:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from deepfake_vit_tpu_torch.ops.cuda_build import _nvcc

    return str(Path(_nvcc()).with_name(name))


def demangle(name: str) -> str:
    out = subprocess.run([_tool("cu++filt"), name], capture_output=True, text=True)
    return (out.stdout.strip() or name).replace("(anonymous namespace)::", "")


def build(root: Path):
    """(library path, {kernel: {"regs": n, "spill": (stores, loads)}})."""
    out = subprocess.run([sys.executable, "-c", BUILD, str(root)], capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"sass_diff: build failed under {root}:\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    info, cur = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = demangle(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info.setdefault(cur, {})["regs"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            info.setdefault(cur, {})["spill"] = (int(m.group(1)), int(m.group(2)))
    return Path(lines[-1]), info


def sass(lib: Path) -> dict:
    """{kernel: [instruction, ...]} without addresses or encodings."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = demangle(m.group(1))
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur:
            funcs[cur].append(re.sub(r"\s+", " ", m.group(1)))
    return funcs


def main() -> None:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    (old_lib, old_info), (new_lib, new_info) = (build(Path(r).resolve()) for r in sys.argv[1:3])
    old, new = sass(old_lib), sass(new_lib)
    print(f"{len(old)} kernels before, {len(new)} after")
    for f in sorted(set(old) | set(new)):
        a, b = old.get(f), new.get(f)
        ri = (old_info.get(f), new_info.get(f))
        if a is None or b is None:
            print(f"{'gone' if b is None else 'new'}: {f} {ri}")
        elif a == b:
            print(f"same SASS ({len(a)} instr): {f} {ri}")
        else:
            d = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
                 if line[:1] in "+-" and line[:3] not in ("+++", "---")]
            print(f"DIFFERS ({len(a)} -> {len(b)} instr, {len(d)} diff lines): {f} {ri}")
            for line in d[:12]:
                print("    " + line)


if __name__ == "__main__":
    main()
