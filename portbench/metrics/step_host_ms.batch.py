"""Host time of a CoocEngine.step in the batch cell: the harness's span
around it less the device busy time inside it (ms)."""
from portbench import readers


def read(obs):
    return readers.step_host_ms(obs)
