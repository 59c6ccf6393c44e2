"""Device time a whole network of the MEDLINE shard of the operations
launched inside the program's cooc.materialize.topk spans (self pairs
cleared, each row's top-k), charged by launch as ``topk_ms.network`` is.
From the profiler's trace (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.launched_ms_per_network(obs, "cooc.materialize.topk")
