"""Share of the corpus that the whole network's row groups count over:
the ``docs`` attribute of the program's cooc.materialize.masks spans in
the traced window (the documents of each group's co-occurrence launch),
summed over the spans that carry it, over those spans times the corpus's
documents (%).  None where the run was not traced, the program keeps no
spans or dropped some, or no span in the window carries ``docs``."""
from portbench import program_spans

SPAN = "cooc.materialize.masks"


def read(obs):
    trace, shape = obs.get("trace"), obs.get("shape")
    ring = program_spans._ring()
    if trace is None or not shape or ring is None or ring[1]:
        return None
    docs = [s[4]["docs"] for s in ring[0]
            if s[0] == SPAN and s[2] > trace.lo and s[1] < trace.hi
            and "docs" in s[4]]
    if not docs:
        return None
    return 100.0 * sum(docs) / (len(docs) * shape["n_docs"])
