#!/usr/bin/env python3
"""Names of the JAX package that the PyTorch port lacks.

    python3 tools/port_ast_diff.py

Parses both packages (no import) and prints, module by module, each
top-level function and class of ``avede_tpu/`` (and each method of its
classes) that the module of the same path under ``avede_tpu_torch/``
does not define, and each module the port has no file for. Private
names (a leading underscore) are left out.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, Set

ROOT = Path(__file__).resolve().parent.parent


def names(path: Path) -> Set[str]:
    """Public top-level functions and classes, and ``Class.method``."""
    out: Set[str] = set()
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))
    return out


def diff(ref: Path, port: Path) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for src in sorted(ref.rglob("*.py")):
        rel = src.relative_to(ref)
        twin = port / rel
        if not twin.exists():
            out[str(rel)] = "no module"
            continue
        missing = sorted(names(src) - names(twin))
        if missing:
            out[str(rel)] = missing
    return out


def main() -> int:
    result = diff(ROOT / "avede_tpu", ROOT / "avede_tpu_torch")
    for mod, missing in result.items():
        print(f"{mod}: {missing if isinstance(missing, str) else ', '.join(missing)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
