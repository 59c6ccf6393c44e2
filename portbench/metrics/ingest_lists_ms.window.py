"""Mean time to pad an ingest's token lists into its block in the window
cell: the program's cooc.ingest.lists spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.ingest.lists")
