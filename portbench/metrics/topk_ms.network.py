"""Device time a whole network of the operations launched inside the
program's cooc.materialize.topk spans (self pairs cleared, each row's
top-k), charged by launch: each device operation's correlation id ties it
to the host call that launched it, and that call's start lies in a span,
however late the device runs it.  From the profiler's trace (ms)."""
from portbench import program_spans


def read(obs):
    return program_spans.launched_ms_per_network(obs, "cooc.materialize.topk")
