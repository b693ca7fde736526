"""Serving front ends of the port: the micro-batching ``BatchQueue`` with its
QoS tick packer, cache warming and ``e2lsh_serve_*`` telemetry; and
``ServeEngine``, LM prefill and greedy decode with the E2LSHoS retrieval
hook."""
from .engine import (BatchQueue, DeadlineExceeded, GenerationResult, QueryTicket,
                     ServeEngine, TickStats)

__all__ = ["BatchQueue", "DeadlineExceeded", "QueryTicket", "TickStats", "ServeEngine",
           "GenerationResult"]
