"""The cascade's three CostRegNets, device ms a request: the sum over the
stages of the mean device ms of the port's ``casmvsnet.costreg{s}`` spans."""

from mvsbench.spans import mean_device_ms


def read(record):
    stages = [mean_device_ms(record, f"casmvsnet.costreg{s}") for s in (1, 2, 3)]
    return None if None in stages else sum(stages)
