"""Host time a batch in CoocEngine.submit in the batch cell: the
program's cooc.engine.submit spans of the traced window over its engine
steps (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.per_step_ms(obs, "cooc.engine.submit")
