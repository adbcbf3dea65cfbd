"""ntt_ms (NTT): device ms a traced batch in the ``intt`` span: the
Montgomery conversion of the values and the inverse transforms."""

from . import span_device_ms


def read(record):
    return span_device_ms(record, "intt")
