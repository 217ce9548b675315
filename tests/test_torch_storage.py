"""The port's ledger digests and storage layer against the JAX package's:
the same array bytes must give byte-identical on-chain values (tree
digests, chunk CIDs, Merkle roots, manifest CIDs) in both packages."""
import jax
import numpy as np
import pytest
import torch

from repro.core import ledger as jledger
from repro.obs import MetricsRegistry as JMetrics
from repro.storage import ExpertCache as JCache
from repro.storage import ExpertStore as JStore
from repro.storage import StorageNetwork as JNetwork
from repro.storage import chunks as jchunks
from repro_torch.core import ledger
from repro_torch.obs import MetricsRegistry
from repro_torch.storage import ExpertCache, ExpertStore, StorageNetwork
from repro_torch.storage import chunks


def _expert(seed, d=784, h=256, o=10):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((d, h)).astype(np.float32),
            "b1": rng.standard_normal(h).astype(np.float32),
            "w2": rng.standard_normal((h, o)).astype(np.float32),
            "b2": rng.standard_normal(o).astype(np.float32)}


TREES = [
    _expert(0, 8, 4, 2),
    {"w": np.ones((3, 2), np.float32), "b": np.zeros(2, np.float32)},
    {"a": {"y": np.arange(3), "x": np.float32(2.0)}, "b": [np.ones(2), 1.5],
     "c": (np.zeros(1),), "d": (1, 2), "e": None, "f": []},
    np.arange(4),
    [np.ones(1)],
    {},
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_treedef_string_and_digest_match_jax(i):
    tree = TREES[i]
    leaves, treedef = ledger.tree_flatten(tree)
    jleaves, jtreedef = jax.tree_util.tree_flatten(tree)
    assert treedef == str(jtreedef)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a is b
    assert ledger.digest_tree(tree) == jledger.digest_tree(tree)
    rebuilt = ledger.tree_unflatten(tree, leaves)
    assert ledger.tree_flatten(rebuilt)[1] == treedef


def test_digest_tree_of_tensors_matches_numpy():
    tree = _expert(1, 16, 8, 4)
    as_torch = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert ledger.digest_tree(as_torch) == jledger.digest_tree(tree)
    assert ledger.digest_array(as_torch["w1"]) == \
        jledger.digest_array(tree["w1"])


@pytest.mark.parametrize("chunk_bytes", [1 << 16, 4096, 1000])
def test_manifest_cids_and_roots_match_jax(chunk_bytes):
    tree = _expert(2)
    m, parts = chunks.build_manifest("expert/3", 5, tree, chunk_bytes)
    jm, jparts = jchunks.build_manifest("expert/3", 5, tree, chunk_bytes)
    assert m.treedef == jm.treedef == "PyTreeDef({'b1': *, 'b2': *, " \
                                      "'w1': *, 'w2': *})"
    assert m.chunk_cids == jm.chunk_cids
    assert m.root == jm.root
    assert m.manifest_cid == jm.manifest_cid
    assert m.to_json() == jm.to_json()
    assert parts == jparts
    # chunk membership proofs verify against the root in both packages
    assert m.verify_chunk(1, parts[1], m.prove_chunk(1))
    assert jm.verify_chunk(1, parts[1], m.prove_chunk(1))


def test_blob_serialization_round_trip():
    tree = _expert(3, 8, 4, 2)
    blob = chunks.serialize_tree(tree)
    back = chunks.deserialize_tree(blob, tree)
    jback = jchunks.deserialize_tree(blob, tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
        np.testing.assert_array_equal(jback[k], tree[k])
    with pytest.raises(ValueError, match="treedef"):
        chunks.deserialize_tree(blob, {"w": tree["w1"]})


def _publish(store_cls, net_cls, metrics_cls, versions):
    net = net_cls(num_nodes=4, replication=2, seed=0, metrics=metrics_cls())
    store = store_cls(net, chunk_bytes=1 << 14)
    cids = []
    for v, tree in enumerate(versions):
        cids.append(store.put_version("expert/0", tree, v).manifest_cid)
    return net, store, cids


def test_store_versions_and_stats_match_jax():
    base = _expert(4, 64, 32, 10)
    changed = dict(base, b2=base["b2"] + 1)        # one leaf changes
    versions = [base, changed, changed]
    _, store, cids = _publish(ExpertStore, StorageNetwork, MetricsRegistry,
                              versions)
    _, jstore, jcids = _publish(JStore, JNetwork, JMetrics, versions)
    assert cids == jcids
    assert dict(store.stats) == dict(jstore.stats)


def test_store_and_cache_round_trip_bytes():
    tree = _expert(5)
    like = {k: v for k, v in tree.items()}
    net = StorageNetwork(num_nodes=4, replication=2, seed=1,
                         metrics=MetricsRegistry())
    store = ExpertStore(net, chunk_bytes=1 << 16)
    store.put_version("expert/1", {k: torch.from_numpy(v)
                                   for k, v in tree.items()}, 0)
    cache = ExpertCache(store)
    first = cache.get("expert/1", 0, like)
    again = cache.get("expert/1", 0, like)
    assert cache.stats["misses"] == 1 and cache.stats["hits"] == 1
    fetched = store.fetch("expert/1", 0, like)
    for k in tree:
        assert first[k].tobytes() == tree[k].tobytes()
        assert again[k] is first[k]
        assert fetched[k].tobytes() == tree[k].tobytes()
    # the JAX cache over the JAX store reads back the same bytes
    jnet = JNetwork(num_nodes=4, replication=2, seed=1)
    jstore = JStore(jnet, chunk_bytes=1 << 16)
    jstore.put_version("expert/1", tree, 0)
    jtree = JCache(jstore).get("expert/1", 0, like)
    assert jstore.manifest_cid("expert/1", 0) == \
        store.manifest_cid("expert/1", 0)
    for k in tree:
        assert np.asarray(jtree[k]).tobytes() == first[k].tobytes()


def test_corrupted_replica_is_served_around():
    tree = _expert(6, 32, 16, 4)
    net = StorageNetwork(num_nodes=3, replication=2, seed=0)
    store = ExpertStore(net, chunk_bytes=1 << 12)
    man = store.put_version("expert/2", tree, 0)
    cid = man.chunk_cids[0]
    net.corrupt_replica(cid, net.replicas(cid)[0])
    for _ in range(6):          # seeded random read order: some read
        back = store.fetch("expert/2", 0, tree)  # hits the bad copy first
        assert back["b1"].tobytes() == tree["b1"].tobytes()
    assert any(f.kind == "corrupted" for f in net.faults)


def test_ledger_blocks_hash_like_jax():
    payload = {"round": 3, "kind": "infer", "bank_root": "ab" * 8,
               "support": [7, 7, 10]}
    blk = ledger.Block(1, "0" * 64, payload, nonce=42, miner=2)
    jblk = jledger.Block(1, "0" * 64, payload, nonce=42, miner=2)
    assert blk.header_bytes() == jblk.header_bytes()
    assert blk.hash == jblk.hash
    chain = ledger.Ledger()
    assert chain.head.hash == jledger.Ledger().head.hash
    chain.append(ledger.Block(1, chain.head.hash, payload))
    assert chain.verify_chain() and chain.find(round=3) is chain.head
    with pytest.raises(ValueError):
        chain.append(ledger.Block(2, "f" * 64, {}))
    chain.blocks[1].payload["round"] = 4          # tamper
    chain.append(ledger.Block(2, chain.head.hash, {}))
    chain.blocks[1].payload["round"] = 5
    assert not chain.verify_chain()


@pytest.mark.parametrize("shards,row_index", [(1, False), (2, True)])
def test_output_commitments_match_jax(shards, row_index):
    from repro.trust import commitments as jcom
    from repro_torch.trust import commitments as com
    rng = np.random.default_rng(shards)
    outs = rng.standard_normal((4, 24, 10)).astype(np.float32)
    rows = (rng.integers(0, 50, size=(4, 24)).astype(np.int32)
            if row_index else None)
    kw = dict(round_id=7, executor=1, chunks_per_expert=4,
              task_digest="t", row_index=rows, num_shards=shards)
    c = com.commit_outputs(outs, **kw)
    jc = jcom.commit_outputs(outs, **kw)
    assert c.root == jc.root and c.leaf_digests == jc.leaf_digests
    assert c.routing_digest == jc.routing_digest
    path = c.tree().prove(5)
    assert com.MerkleTree.verify(jc.root, jc.leaf_digests[5], path)
    assert com.leaf_digest_batch(outs[:, :6]) == \
        jcom.leaf_digest_batch(outs[:, :6])
