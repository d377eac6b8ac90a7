"""Device, in the open-loop cell (where the offered rate fixes the
throughput): the share of a tick in which no operation runs on the
device, as ``device_idle_pct``."""

from xlbench.metrics import reader

read = reader("device_idle_pct")
