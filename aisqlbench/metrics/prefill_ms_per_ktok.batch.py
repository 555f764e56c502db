"""Wall time of the continuous batcher's chunked-prefill steps per 1,000
prompt tokens they wrote to the paged pool (ms/ktok)."""


def read(run):
    t = sum(b - a for k, a, b, *_ in run.steps if k == "prefill")
    n = sum(n for k, _, _, n, _ in run.steps if k == "prefill")
    return 1e3 * t / (n / 1e3) if n else None
