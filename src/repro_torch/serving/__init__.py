"""Serving front end of the port: the micro-batching ``BatchQueue`` with its
QoS tick packer, cache warming and ``e2lsh_serve_*`` telemetry."""
from .engine import BatchQueue, DeadlineExceeded, QueryTicket, TickStats

__all__ = ["BatchQueue", "DeadlineExceeded", "QueryTicket", "TickStats"]
