"""Count the SASS instructions of the kernels in a built library.

    python -m fav_tpu_torch.tools.sass_count LIBRARY.so [--kernel NAME] [--dump FILE]

Runs ``cuobjdump -sass`` (the CUDA toolkit's, beside ``nvcc``) on a library
that ``ops/_build.py`` built, splits its output by function and prints one
JSON line a function whose mangled name contains ``NAME``:

* ``instructions``: every instruction of the function but ``NOP``;
* ``loops``: for each backward branch, the instructions of its span (from
  the branch's target to the branch) and of the shortest path through that
  span from its first instruction to the branch, taking either side of each
  forward branch and no inner loop; ``ops`` counts that path's
  instructions by opcode (the mnemonic before its first dot).

The shortest path is the trip a loop body takes when every test in it goes
the common way: ptxas lays a math call's rare cases (``cosf``'s large
arguments, ``sqrtf``'s subnormals) and a wrapper's unaligned case out as
longer detours, inner loops or calls (a path avoids a ``CALL`` wherever it
can; one it cannot avoid counts as one instruction). A kernel's instructions an element are a
loop's shortest path over the elements one trip handles (K1's main loop:
4 x ``kGaussGroups``).
``--dump`` keeps the whole disassembly. Needs the card's machine: there is
no ``cuobjdump`` here.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

__all__ = ["cuobjdump", "parse_functions", "loops", "count", "main"]

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch's target: a label (`(.L_x_3)) or an address (0x1c40), by the
# toolkit's version
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-fA-F]+)\s*$")
_CALL_WEIGHT = 10_000


def cuobjdump() -> str:
    """``cuobjdump`` beside the ``nvcc`` that builds the kernels, else on ``PATH``."""
    from fav_tpu_torch.ops._build import find_nvcc

    beside = Path(find_nvcc()).with_name("cuobjdump")
    if beside.exists():
        return str(beside)
    found = shutil.which("cuobjdump")
    if not found:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def parse_functions(text: str) -> dict[str, list[dict]]:
    """``{mangled name: [{"addr", "text", "label"}]}`` from ``cuobjdump
    -sass`` output; ``label`` is the label that names the instruction's
    address, if any."""
    functions: dict[str, list[dict]] = {}
    current = None
    pending = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            pending = None
            continue
        if current is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending = m.group(1)
            continue
        m = _INSTRUCTION.match(line)
        if m:
            current.append({"addr": int(m.group(1), 16), "text": m.group(2).strip(), "label": pending})
            pending = None
    return functions


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _branch(text: str) -> tuple[bool, str | None]:
    """(conditional, target) of a ``BRA``, else (False, None); the target is
    a label or an address in hex."""
    if _opcode(text) != "BRA":
        return False, None
    m = _TARGET.search(text)
    target = (m.group(1) or m.group(2).lower()) if m else None
    return text.startswith("@"), target


def _weight(text: str) -> int:
    """An instruction's cost in the path search: a ``CALL`` stands for its
    callee's instructions, which a path avoids wherever it can."""
    op = _opcode(text)
    return 0 if op == "NOP" else (_CALL_WEIGHT if op == "CALL" else 1)


def loops(instructions: list[dict]) -> list[dict]:
    """Each backward branch's span and shortest path (module docstring)."""
    where = {ins["label"]: i for i, ins in enumerate(instructions) if ins["label"]}
    where.update({hex(ins["addr"]): i for i, ins in enumerate(instructions)})
    out = []
    for end, ins in enumerate(instructions):
        _, target = _branch(ins["text"])
        if target is None or target not in where or where[target] > end:
            continue
        start = where[target]
        span = [x for x in instructions[start:end + 1] if _opcode(x["text"]) != "NOP"]
        # shortest path over the span's forward edges, in address order
        cost = {start: (_weight(instructions[start]["text"]), None)}
        for i in range(start, end):
            if i not in cost:
                continue
            text = instructions[i]["text"]
            cond, tgt = _branch(text)
            succ = []
            if _opcode(text) != "EXIT" or text.startswith("@"):
                if tgt is None or cond:
                    succ.append(i + 1)
                if tgt is not None and tgt in where and i < where[tgt] <= end:
                    succ.append(where[tgt])
            for j in succ:
                c = cost[i][0] + _weight(instructions[j]["text"])
                if j not in cost or c < cost[j][0]:
                    cost[j] = (c, i)
        path: list[str] = []
        i = end if end in cost else None
        while i is not None:
            if _opcode(instructions[i]["text"]) != "NOP":
                path.append(instructions[i]["text"])
            i = cost[i][1]
        out.append({"start": instructions[start]["addr"], "end": ins["addr"], "span": len(span),
                    "shortest": len(path) if end in cost else None,
                    "ops": dict(Counter(_opcode(t) for t in path).most_common())})
    return out


def count(instructions: list[dict]) -> dict:
    """The function's instruction count, opcodes and loops."""
    body = [x["text"] for x in instructions if _opcode(x["text"]) != "NOP"]
    return {"instructions": len(body), "ops": dict(Counter(_opcode(t) for t in body).most_common()),
            "loops": loops(instructions)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("library")
    ap.add_argument("--kernel", default="", help="a substring of the mangled names to report")
    ap.add_argument("--dump", help="write the whole disassembly here")
    args = ap.parse_args(argv)
    text = subprocess.run([cuobjdump(), "-sass", args.library], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        Path(args.dump).write_text(text)
    found = 0
    for name, instructions in parse_functions(text).items():
        if args.kernel in name:
            found += 1
            print(json.dumps({"library": Path(args.library).name, "function": name, **count(instructions)}))
    if not found:
        print(f"sass_count: no function matching {args.kernel!r} in {args.library}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
