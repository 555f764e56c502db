"""Requests in each engine ``submit_batch`` call, averaged over the
window's calls: how far the client stack coalesces queries (rows)."""


def read(run):
    n = [k for _, _, k in run.dispatches]
    return sum(n) / len(n) if n else None
