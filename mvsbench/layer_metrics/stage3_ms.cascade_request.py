"""CasMVSNet's stage 3 (full resolution, 8 per-pixel planes), device ms a
request: the port's ``casmvsnet.stage3`` span, its mean."""

from mvsbench.spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "casmvsnet.stage3")
