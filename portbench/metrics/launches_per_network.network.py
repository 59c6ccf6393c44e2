"""Co-occurrence kernel launches (ops.LAUNCHES['cooccur_counts']) per whole
network."""
from portbench import readers


def read(obs):
    return readers.launches_per_network(obs)
