"""Sites that take an id from a caller which the port leaves as they are,
because both packages already answer alike, on the CPU.

These are host code in both packages (numpy, or checks before any
device work), so an id out of range raises the same error in both, or
gives the same answer:

- the host references ``recursive_construct_host``,
  ``bfs_construct_host`` and ``bfs_construct_host_fast`` (``counts[term]
  = -1``, ``x[:, seed]``): a seed of V or more, or below -V, raises
  ``IndexError`` in both; -1 counts from the end in both;
- ``QueryContext.tag_scope``: a doc id of the capacity or more, or
  negative, raises ``ValueError`` in both;
- the neighbour sampler ``sample_subgraph``: a seed past the nodes
  raises ``IndexError`` in both, -1 ``ValueError`` in both;
- ``pack_docs`` and ``ingest``: a term id outside [0, V) is dropped by
  both;
- ``QuerySpec``: a negative seed is refused by both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.data as JD  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.data as TD  # noqa: E402

DOCS = [[0, 1, 2], [1, 2, 3], [0, 3], [2, 4], [0, 1, 4]] * 8
V = 5


def _both(fn):
    """(outcome, value) of ``fn(package)`` for the reference and the port:
    ("ok", result) or (the exception's type, its message)."""
    out = []
    for pkg in ("ref", "port"):
        try:
            out.append(("ok", fn(pkg)))
        except Exception as e:              # noqa: BLE001 -- compared below
            out.append((type(e).__name__, str(e)))
    return out


def _agree(fn):
    (a, x), (b, y) = _both(fn)
    assert a == b, (a, x, b, y)
    if a == "ok":
        assert x == y
    return a


def _incidence():
    x = np.zeros((len(DOCS), V), bool)
    for d, terms in enumerate(DOCS):
        x[d, terms] = True
    return x


@pytest.mark.parametrize("seed,outcome", [(5, "IndexError"),
                                          (8, "IndexError"),
                                          (-6, "IndexError"), (-1, "ok")])
def test_host_references_agree_on_a_seed_out_of_range(seed, outcome):
    x = _incidence()
    pkg = {"ref": J, "port": T}
    assert _agree(lambda p: pkg[p].recursive_construct_host(
        x, seed, 2, 2)) == outcome
    assert _agree(lambda p: pkg[p].bfs_construct_host(x, seed, 2, 2)) == \
        outcome
    assert _agree(lambda p: pkg[p].bfs_construct_host_fast(
        pkg[p].build_host_index(DOCS, V), [seed], depth=2, topk=2,
        beam=2)) == outcome


@pytest.mark.parametrize("ids,outcome", [([0, 45], "ok"), ([-1], "ValueError"),
                                         ([100], "ValueError")])
def test_tag_scope_agrees_on_doc_ids_out_of_range(ids, outcome):
    def scope(p):
        if p == "ref":
            ctx = J.QueryContext.from_docs(DOCS, V)
        else:
            ctx = T.QueryContext.from_docs(DOCS, V, device="cpu")
        ctx.tag_scope("s", np.asarray(ids))
        bits = ctx.scope("s")
        return (np.asarray(bits) if p == "ref"
                else T.to_uint32(bits)).tolist()
    assert _agree(scope) == outcome


@pytest.mark.parametrize("seeds,outcome", [([4], "IndexError"),
                                           ([7], "IndexError"),
                                           ([-1], "ValueError"), ([3], "ok")])
def test_sampler_agrees_on_a_seed_out_of_range(seeds, outcome):
    src, dst = np.asarray([0, 1, 2, 3]), np.asarray([1, 2, 3, 0])
    pkg = {"ref": JD, "port": TD}

    def sample(p):
        indptr, indices = pkg[p].build_csr(src, dst, 4)
        out = pkg[p].sample_subgraph(indptr, indices, np.asarray(seeds), [2],
                                     np.random.default_rng(0))
        return {k: np.asarray(v).tolist() for k, v in out.items()}
    assert _agree(sample) == outcome


def test_pack_and_ingest_drop_terms_out_of_range():
    docs = [[0, 5, 1], [-2, 3, 8], [4, 4, 7]]
    want = J.pack_docs(docs, V, capacity=64)
    got = T.pack_docs(docs, V, capacity=64, device="cpu")
    np.testing.assert_array_equal(T.to_uint32(got.packed),
                                  np.asarray(want.packed))
    np.testing.assert_array_equal(got.doc_freq.numpy(),
                                  np.asarray(want.doc_freq))
    block = np.asarray([[1, 6, -3], [9, 2, 0]], np.int32)
    valid = np.asarray([True, True])
    want = J.ingest(want, jnp.asarray(block), jnp.asarray(valid))
    got = T.ingest(got, torch.from_numpy(block), torch.from_numpy(valid))
    np.testing.assert_array_equal(T.to_uint32(got.packed),
                                  np.asarray(want.packed))
    np.testing.assert_array_equal(got.doc_freq.numpy(),
                                  np.asarray(want.doc_freq))


def test_query_spec_refuses_a_negative_seed_in_both():
    for pkg in (J, T):
        with pytest.raises(ValueError, match="negative seed"):
            pkg.QuerySpec(seeds=(3, -1))
