"""Nearest-rank p95 of the search cell's requests' wait in the server's
queue: the program's cooc.server.queue spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.p95_ms(obs, "cooc.server.queue")
