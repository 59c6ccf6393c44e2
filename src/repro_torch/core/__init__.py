"""The paper's core in PyTorch: the bit-packed inverted index, the BFS
construction (Algorithm 3), the typed query surface and the query
context.  Mirrors ``repro.core`` for the parts ported so far."""
from repro_torch.core.inverted_index import (  # noqa: F401
    Lexicon,
    PackedIndex,
    dense_operand,
    doc_freq_under_batch,
    doc_freq_under_batch_gemm,
    empty_mask,
    from_uint32,
    grow_capacity,
    grow_vocab,
    incidence_dense,
    ingest,
    ingest_at,
    pack_docs,
    slots_bitmap,
    to_uint32,
    unpack_bitmap,
)
from repro_torch.core.network import (  # noqa: F401
    CoocNetwork,
    canonical_pairs,
    merge_duplicates,
    nodes_of,
    to_edge_dict,
    to_edge_index,
    top_edges,
)
from repro_torch.core.query import (  # noqa: F401
    CountMethod,
    PlanKey,
    QueryResult,
    QuerySpec,
    canonical_exec_key,
    canonicalize_request,
    count_method_names,
    get_count_method,
    register_count_method,
    unregister_count_method,
)
from repro_torch.core.query_context import (  # noqa: F401
    CapacityError,
    QueryContext,
    context_from_state,
)
from repro_torch.core.cooccurrence import (  # noqa: F401
    HostIndex,
    bfs_construct,
    bfs_construct_batch,
    bfs_construct_host_fast,
    build_host_index,
    chunked_top_k,
    construct,
    traversal_construct_host,
)
