"""Device idle a whole network inside the program's cooc.materialize.topk
spans (self pairs cleared, each row's top-k), from the profiler's trace
(ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.idle_ms_per_network(obs, "cooc.materialize.topk")
