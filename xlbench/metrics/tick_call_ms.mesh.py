"""The same reading as ``tick_call_ms``, in the Bookinfo mesh, whose
metrics move its device cost a request (``device_ms_per_req``), not the
gateway's rate."""

from xlbench.metrics import reader

read = reader("tick_call_ms")
