"""outside_engine_share.serve (%): of the executor's time on the window's
batches, from each ``generate_batch``'s assign to its close (the harness's
wrapper of ``_execute``), the share spent outside ``ServeEngine.generate``
(CFS uploads, the close, the handler's padding)."""


def read(run: dict) -> float | None:
    batches = run["batches"]
    total = sum(b["end"] - b["start"] for b in batches)
    if not batches or total <= 0:
        return None
    return 100.0 * (1.0 - sum(b["engine_s"] for b in batches) / total)
