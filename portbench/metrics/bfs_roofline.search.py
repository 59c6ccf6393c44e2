"""The search cell's BFS levels: least time by the roofline count over the
level-step kernel's device time (%)."""
from portbench import readers


def read(obs):
    return readers.bfs_roofline(obs)
