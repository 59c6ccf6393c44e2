"""Mean time to bring an evicted block's payload to the host and encode
it in the window cell: the program's cooc.spill.encode spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.spill.encode")
