"""Host time of an engine step before its levels in the batch cell: the
mean of the program's cooc.engine.prepare spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.engine.prepare")
