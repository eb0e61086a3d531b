"""Signed request envelopes (paper §3.4.6), the client's half.

A copy of ``canonical`` and ``sign_envelope`` from the reference's
``repro/core/security.py``. Every API request is a signed envelope::

    {"payloadtype": "submitfunctionspec", "payload": "<json>", "signature": "<hex>"}

The broker recovers the signer's identity from (payloadtype || payload ||
msgid, signature); opening envelopes is the broker's side and is not
copied.
"""

from __future__ import annotations

import json

from .crypto import Crypto


def canonical(payload: dict) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def sign_envelope(
    payloadtype: str, payload: dict, prvkey: str, msgid: str | None = None
) -> dict:
    """Sign an envelope; an idempotency key (``msgid``) is folded into the
    signed string so a replayed-by-attacker envelope cannot be re-keyed
    (tampering with msgid breaks signature recovery — see ROBUSTNESS.md).
    Envelopes without a msgid sign exactly as before (back-compat)."""
    body = canonical(payload)
    sig = Crypto.sign(payloadtype + body + (msgid or ""), prvkey)
    env = {"payloadtype": payloadtype, "payload": body, "signature": sig}
    if msgid:
        env["msgid"] = msgid
    return env
