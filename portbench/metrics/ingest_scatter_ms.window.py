"""Mean time of an ingest's scatter into the index in the window cell:
the program's cooc.ingest.scatter spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.ingest.scatter")
