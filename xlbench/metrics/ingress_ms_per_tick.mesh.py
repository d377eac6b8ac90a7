"""The same reading as ``ingress_ms_per_tick``, in the Bookinfo mesh, whose
metrics move its device cost a request (``device_ms_per_req``), not the
gateway's rate."""

from xlbench.metrics import reader

read = reader("ingress_ms_per_tick")
