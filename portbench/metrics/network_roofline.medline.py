"""The MEDLINE shard's whole network: least time by the roofline count
over the co-occurrence kernel's device time (%)."""
from portbench import readers


def read(obs):
    return readers.network_roofline(obs)
