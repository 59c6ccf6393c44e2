"""Mean time of the cold store's write of a block (write, fsyncs, rename)
in the window cell: the program's cooc.spill.write spans (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.mean_ms(obs, "cooc.spill.write")
