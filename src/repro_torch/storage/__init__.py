"""Decentralized storage layer (paper §IV-A(4)), ported from
``repro.storage``: chunked Merkle manifests, the replicated network, the
versioned ``ExpertStore``, the edge-side ``ExpertCache`` and the serving
engine's ``KVBlockStore``."""
from repro_torch.storage.cache import ExpertCache, GateEMA
from repro_torch.storage.chunks import (DEFAULT_CHUNK_BYTES, ChunkManifest,
                                        LeafSpec, assemble_tree,
                                        build_manifest, deserialize_tree,
                                        serialize_tree, split_chunks)
from repro_torch.storage.kv import (KV_GENESIS, KVBlockStore,
                                    KVStorageConfig, prefix_chain, prefix_cid)
from repro_torch.storage.network import (DataUnavailable, NetworkCostModel,
                                         ReplicaFault, StorageNetwork,
                                         StorageNode)
from repro_torch.storage.store import ChunkUnavailableError, ExpertStore

__all__ = [
    "ExpertCache", "GateEMA",
    "DEFAULT_CHUNK_BYTES", "ChunkManifest", "LeafSpec", "assemble_tree",
    "build_manifest", "deserialize_tree", "serialize_tree", "split_chunks",
    "KV_GENESIS", "KVBlockStore", "KVStorageConfig", "prefix_chain",
    "prefix_cid",
    "DataUnavailable", "NetworkCostModel", "ReplicaFault", "StorageNetwork",
    "StorageNode", "ChunkUnavailableError", "ExpertStore",
]
