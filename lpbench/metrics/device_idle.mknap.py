"""``device_idle.mknap``: the share of the traced window in which no
operation ran on the card (the union of device intervals)."""
from lpbench.metrics._common import idle_pct


def read(record):
    return idle_pct(record)
