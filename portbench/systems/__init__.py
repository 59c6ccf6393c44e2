"""One module per system the benchmark runs, named by a
configuration's ``"system"``."""
