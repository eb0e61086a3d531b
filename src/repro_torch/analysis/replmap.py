"""Generated replicated-op matrix: op → apply handler → entry contract.

``python -m repro_torch.analysis.replmap`` reads the ``REPLICATED_OPS``
literal in ``broker/cluster.py`` (the same table ``replint`` roots its
apply cone at and ``HAColonyCluster`` dispatches from) and emits the
matrix between the ``BEGIN REPLMAP-TORCH`` / ``END REPLMAP-TORCH``
markers in TORCH_CONTRACTS.md. A copy of the reference's
``repro/analysis/replmap.py``; its rows are the reference's.

Modes:

* ``--check`` (CI): exit non-zero if the committed TORCH_CONTRACTS.md
  section differs from what the code implies — the docs can never drift.
* ``--write``: rewrite the section in place.
* default: print the generated section to stdout.

Generation refuses on a failing ``replint`` tree: a matrix describing
ops whose apply cone is nondeterministic would document a lie.
"""

from __future__ import annotations

import os
import sys

from .replint import run as replint_run

CONTRACTS_MD = "TORCH_CONTRACTS.md"
BEGIN = ("<!-- BEGIN REPLMAP-TORCH (generated by python -m"
         " repro_torch.analysis.replmap --write) -->")
END = "<!-- END REPLMAP-TORCH -->"


def generate(paths: list[str] | None = None) -> str:
    """The generated matrix section, markers included."""
    _nfiles, _cone, violations = replint_run(paths)
    hard = [v for v in violations if v.rule != "REP000"]
    if hard:
        raise SystemExit(
            "replmap refuses to generate from a failing tree; run"
            " `python -m repro_torch.analysis.replint` first"
            f" ({len(hard)} violation(s))"
        )
    from .replint import _py_files, collect_ops

    if not paths:
        from .replint import DEFAULT_PATHS

        paths = [p for p in DEFAULT_PATHS if os.path.exists(p)]
    sources = []
    for f in _py_files(list(paths)):
        with open(f, "r", encoding="utf-8") as fh:
            sources.append((f, fh.read()))
    ops = collect_ops(sources)
    if not ops:
        raise SystemExit(
            "replmap: no REPLICATED_OPS literal found in the linted tree"
        )
    lines = [
        BEGIN,
        "",
        "| op | apply handler | required entry fields | leader-stamped | CAS guard |",
        "|---|---|---|---|---|",
    ]
    for op in sorted(ops):
        spec = ops[op]
        required = ", ".join(f"`{f}`" for f in spec.get("required", ()))
        stamped = ", ".join(f"`{f}`" for f in spec.get("leader_stamped", ()))
        lines.append(
            f"| `{op}` | `{spec.get('apply', '?')}` | {required} |"
            f" {stamped} | {spec.get('cas', '?')} |"
        )
    lines += ["", END]
    return "\n".join(lines)


def _split(doc: str) -> tuple[str, str, str]:
    """(before, section, after); raises if the markers are missing."""
    try:
        head, rest = doc.split(BEGIN, 1)
        mid, tail = rest.split(END, 1)
    except ValueError:
        raise SystemExit(
            f"{CONTRACTS_MD} is missing the {BEGIN!r} / {END!r} markers"
        ) from None
    return head, BEGIN + mid + END, tail


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mode = ""
    if args and args[0] in ("--check", "--write"):
        mode = args.pop(0)
    section = generate(args or None)
    if mode == "":
        print(section)
        return 0
    if not os.path.exists(CONTRACTS_MD):
        print(f"replmap: {CONTRACTS_MD} not found (run from the repo root)")
        return 1
    with open(CONTRACTS_MD, "r", encoding="utf-8") as fh:
        doc = fh.read()
    head, current, tail = _split(doc)
    if mode == "--check":
        if current.strip() != section.strip():
            print(
                f"replmap: {CONTRACTS_MD} replicated-op matrix is stale —"
                " regenerate with `python -m repro_torch.analysis.replmap --write`"
            )
            return 1
        print(f"replmap: OK ({CONTRACTS_MD} matches REPLICATED_OPS)")
        return 0
    with open(CONTRACTS_MD, "w", encoding="utf-8") as fh:
        fh.write(head + section + tail)
    print(f"replmap: wrote {CONTRACTS_MD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
