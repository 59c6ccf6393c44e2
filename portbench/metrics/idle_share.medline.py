"""Share of the MEDLINE network cell's traced window in which no device
operation ran (%), from the profiler's trace."""
from portbench import readers


def read(obs):
    return readers.idle_share(obs)
