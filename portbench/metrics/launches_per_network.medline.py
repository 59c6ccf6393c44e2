"""Co-occurrence kernel launches (ops.LAUNCHES['cooccur_counts']) per whole
network of the MEDLINE shard: one a chunk of a row group's documents."""
from portbench import readers


def read(obs):
    return readers.launches_per_network(obs)
