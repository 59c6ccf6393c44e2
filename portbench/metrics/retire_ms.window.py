"""Mean time of an eviction in the window cell, its spill included: the
program's cooc.ingest.retire spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.ingest.retire")
