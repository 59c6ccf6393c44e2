"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
its result as the last line of standard output.  Nothing here imports the
JAX package or JAX.
"""
