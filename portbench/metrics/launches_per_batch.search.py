"""Kernel launches (ops.LAUNCHES, all kernels) over the engine steps of the
search cell's traced window."""
from portbench import readers


def read(obs):
    return readers.launches_per_batch(obs)
