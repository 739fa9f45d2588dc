"""Observability (port of `repro/obs`, in part): the gauges the codec path
and the wire meter read."""
