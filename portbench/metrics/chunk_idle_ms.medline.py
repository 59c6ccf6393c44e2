"""Device idle a whole network of the MEDLINE shard inside the program's
cooc.materialize.chunk spans (each chunk of a row group's documents: its
staging, count and clearing, less the spans nested in it), from the
profiler's trace (ms).  None for a program without such spans."""
from portbench import program_spans


def read(obs):
    return program_spans.idle_ms_per_network(obs, "cooc.materialize.chunk")
