"""Mean QueryResult.batch_occupancy of the search cell's served requests
(queries a batch)."""
from portbench import readers


def read(obs):
    return readers.mean_occupancy(obs)
