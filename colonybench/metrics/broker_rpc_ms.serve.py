"""broker_rpc_ms.serve (ms): the mean signed round trip of the clients'
``pack`` and result polls (``getfiles``) sent in the window, timed in the
clients' process around each RPC."""


def read(run: dict) -> float | None:
    spans = [s for s in run["spans"] if s[0] in ("pack", "getfiles")]
    return 1e3 * sum(s[2] for s in spans) / len(spans) if spans else None
