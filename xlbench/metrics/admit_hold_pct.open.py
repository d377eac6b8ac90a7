"""Balancing, in the open-loop cell (where the offered rate fixes the
throughput and the holds move the tail): admission attempts held per 100
attempts, as ``admit_hold_pct``."""

from xlbench.metrics import reader

read = reader("admit_hold_pct")
