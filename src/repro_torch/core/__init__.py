"""The paper's core in PyTorch: the bit-packed inverted index, the BFS
construction (Algorithm 3) with its host references (Algorithms 1 and 2),
the typed query surface, the query context with its sliding window and
cold tier, exact and sketch-pruned whole-corpus materialization,
snapshots, and the term- and doc-sharded query mesh.  Mirrors
``repro.core``."""
from repro_torch.core.inverted_index import (  # noqa: F401
    Lexicon,
    PackedIndex,
    and_term,
    dense_operand,
    doc_freq_under,
    doc_freq_under_batch,
    doc_freq_under_batch_gemm,
    empty_mask,
    from_uint32,
    grow_capacity,
    grow_vocab,
    incidence_dense,
    ingest,
    ingest_at,
    mask_count,
    pack_docs,
    retire_docs,
    slots_bitmap,
    term_postings,
    to_uint32,
    unpack_bitmap,
)
from repro_torch.core.network import (  # noqa: F401
    CoocNetwork,
    NetworkStats,
    canonical_pairs,
    degree_histogram,
    edge_jaccard,
    global_statistics,
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
    COUNT_METHODS,
    CapacityError,
    QueryContext,
)
from repro_torch.core.cooccurrence import (  # noqa: F401
    HostIndex,
    bfs_construct,
    bfs_construct_batch,
    bfs_construct_host,
    bfs_construct_host_fast,
    build_host_index,
    chunked_top_k,
    construct,
    recursive_construct_host,
    traversal_construct_dense,
    traversal_construct_host,
)
from repro_torch.core.materialize import materialize  # noqa: F401,E402
from repro_torch.core.sketch import (  # noqa: F401
    ApproxCoocNetwork,
    ApproxStats,
    block_signatures,
    candidate_columns,
    hash_coefficients,
    lsh_params,
    lsh_probabilities,
    merge_signatures,
    minhash_signatures,
)
from repro_torch.core.atomic_io import (  # noqa: F401
    atomic_write_bytes,
    atomic_write_text,
    commit_dir,
    staged_dir,
)
from repro_torch.core.storage import (  # noqa: F401
    ColdBlock,
    FileStorage,
    decode_block,
    encode_block,
    make_storage,
)
from repro_torch.core.snapshot import (  # noqa: F401
    SnapshotError,
    context_from_state,
    context_state,
    load_context,
    read_snapshot,
    save_context,
    write_snapshot,
)
from repro_torch.core.distributed import (  # noqa: F401
    CoocMesh,
    make_cooc_mesh,
    n_shards,
    shard_kind,
    sharded_block_topk,
    sharded_counts,
    sharded_signatures,
    validate_mesh,
)
