"""Host time of an engine step after its network reached the host in the
batch cell: the mean of the program's cooc.engine.resolve spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.engine.resolve")
