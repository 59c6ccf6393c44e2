"""Share of the search cell's offered requests that were shed, missed or
failed (%), from the ServeResponse statuses."""
from portbench import readers


def read(obs):
    return readers.shed_share(obs)
