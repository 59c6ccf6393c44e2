"""Mean time of a server lane step in the search cell: the program's
cooc.server.lane_step spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.server.lane_step")
