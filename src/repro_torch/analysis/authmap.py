"""Generated permission matrix: payloadtype → handler → required role.

``python -m repro_torch.analysis.authmap`` walks the port's RPC handler
tables (the same registration dicts authlint verifies) and emits the
paper's Table-5-style permission matrix between the ``BEGIN
AUTHMAP-TORCH`` / ``END AUTHMAP-TORCH`` markers in TORCH_CONTRACTS.md.
A copy of the reference's ``repro/analysis/authmap.py``; its rows are the
reference's, row for row.

Modes:

* ``--check`` (CI): exit non-zero if the committed TORCH_CONTRACTS.md section
  differs from what the code implies — the docs can never drift.
* ``--write``: rewrite the section in place.
* default: print the generated section to stdout.

The required role is read from the auth check each handler performs
(``_require_server_owner`` → server owner, ``_require_colony_owner`` →
colony owner, ``_require_executor`` → executor, ``_require_member`` →
member); authlint separately guarantees every handler has one.
"""

from __future__ import annotations

import os
import sys

from .authlint import run as authlint_run

CONTRACTS_MD = "TORCH_CONTRACTS.md"
BEGIN = ("<!-- BEGIN AUTHMAP-TORCH (generated by python -m"
         " repro_torch.analysis.authmap --write) -->")
END = "<!-- END AUTHMAP-TORCH -->"

# Weakest role accepted per check; see ROLE_SATISFIED_BY in authtrack.py
# for which stronger roles also pass.
_ROLE_NOTE = {
    "server owner": "server owner only",
    "colony owner": "colony owner (or server owner)",
    "executor": "approved executor of the colony",
    "member": "member: owner, approved executor, or registered user",
}


def generate(paths: list[str] | None = None) -> str:
    """The generated matrix section, markers included."""
    _nfiles, handlers, violations = authlint_run(paths)
    hard = [v for v in violations if v.rule != "AUT000"]
    if hard:
        raise SystemExit(
            "authmap refuses to generate from a failing tree; run"
            " `python -m repro_torch.analysis.authlint` first"
            f" ({len(hard)} violation(s))"
        )
    rows = []
    for h in handlers:
        for ptype in h.ptypes:
            rows.append((ptype, f"{h.classname}.{h.name}", h.role or "?"))
    rows.sort()
    lines = [
        BEGIN,
        "",
        "| payloadtype | handler | required role |",
        "|---|---|---|",
    ]
    for ptype, handler, role in rows:
        lines.append(f"| `{ptype}` | `{handler}` | {_ROLE_NOTE.get(role, role)} |")
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
        print(f"authmap: {CONTRACTS_MD} not found (run from the repo root)")
        return 1
    with open(CONTRACTS_MD, "r", encoding="utf-8") as fh:
        doc = fh.read()
    head, current, tail = _split(doc)
    if mode == "--check":
        if current.strip() != section.strip():
            print(
                f"authmap: {CONTRACTS_MD} permission matrix is stale —"
                " regenerate with `python -m repro_torch.analysis.authmap --write`"
            )
            return 1
        print(f"authmap: OK ({CONTRACTS_MD} matches the handler tables)")
        return 0
    with open(CONTRACTS_MD, "w", encoding="utf-8") as fh:
        fh.write(head + section + tail)
    print(f"authmap: wrote {CONTRACTS_MD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
