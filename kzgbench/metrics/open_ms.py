"""open_ms (KZG device layer): device ms a traced batch of the activities
launched in the ``open`` span: evaluations, combination, witnesses."""

from . import span_device_ms


def read(record):
    return span_device_ms(record, "open")
