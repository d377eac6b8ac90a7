"""Decode, in the open-loop cell (where the offered rate fixes the
throughput and the decode's time moves the tail): device ms a tick of
every kernel but B1 and B2, as ``decode_device_ms_per_tick``."""

from xlbench.metrics import reader

read = reader("decode_device_ms_per_tick")
