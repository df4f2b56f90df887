"""The serving entry's copies to the card a request: the port's ``infer.h2d``
span (the three copies and the u8 -> f32 divide), its mean host ms."""

from mvsbench.spans import host_ms_per


def read(record):
    return host_ms_per(record, "infer.h2d")
