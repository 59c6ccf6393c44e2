"""Kernel operands shaped like the port's own, for the kernel tests
(``tests/test_torch_gpu.py`` on the card, ``tests/test_torch_kernels.py``
and ``tests/test_torch_postings_sparse.py`` on the CPU)."""
import numpy as np


def query_masks(rng, n_queries, beam, w, frac):
    """Frontier masks shaped like the BFS's, as a uint32 numpy array: the
    ``beam`` rows of a query are nonzero only inside its seed support (a
    ``frac`` share of the W words, drawn anew per query), each row a random
    subset of it."""
    masks = np.zeros((n_queries * beam, w), np.uint32)
    for qi in range(n_queries):
        support = rng.choice(w, max(1, int(frac * w)), replace=False)
        words = rng.integers(1, 1 << 32, (beam, support.size), dtype=np.uint32)
        words[rng.random(words.shape) < 0.5] = 0
        masks[qi * beam:(qi + 1) * beam, support] = words
    return masks


def structured_operand(kind, rows, d, dev):
    """A (rows, d) int8 0/1 operand of kernel 3: all ones (every count is
    d), or a shifted identity (row i holds doc 37 i mod d only), where a
    wrong swizzle or descriptor would move counts to other cells."""
    import torch
    if kind == "ones":
        return torch.ones((rows, d), dtype=torch.int8, device=dev)
    x = torch.zeros((rows, d), dtype=torch.int8, device=dev)
    i = torch.arange(rows, device=dev)
    x[i, (i * 37) % d] = 1
    return x
