"""host_ms (harness / host protocol): host wall ms a batch in the
benchmark's host spans (``host.challenge``: compressing the commitments and
hashing the challenges; ``host.results``: the evaluations and proofs to
ints and bytes), over every batch of the window (host clock)."""


def read(record):
    s = sum(v for k, v in record.host_span_s.items() if k.startswith("host."))
    return 1e3 * s / len(record.batches) if s > 0 else None
