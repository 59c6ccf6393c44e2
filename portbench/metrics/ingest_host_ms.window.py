"""Host time of an awaited CoocServer.ingest of one block in the window
cell: the harness's span around it less the device busy time inside it
(ms)."""
from portbench import readers


def read(obs):
    return readers.ingest_host_ms(obs)
