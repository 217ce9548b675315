"""Versioned, chunk-deduplicated expert store over the storage network.

One ``ExpertStore`` tracks any number of objects (experts, by
``object_id``), each with a sequence of *versions* keyed by training
round: ``put_version`` chunks the tree (``storage.chunks``),
uploads only the chunks the network does not already hold (unchanged
chunks between versions keep their CIDs — chunk-level dedup), and stores
the version's ``ChunkManifest`` as a content-addressed object of its
own.  The manifest's Merkle ``root`` is what the host records on-chain;
``manifest_cid`` names the exact version for retention accounting.

``fetch`` resolves an object at a version (the latest manifest tagged at
or before it — an expert untouched by rounds r..r+k serves round r+k
from its round-r manifest), pulls each chunk by CID (the network skips
corrupted replicas: verified refetch), verifies the chunk against the
manifest, and reassembles the tree chunk-for-chunk.  A chunk no healthy
replica can produce raises ``ChunkUnavailableError`` — the fault the
data-availability challenges attribute and slash.

Retention: hosts ``retain`` the manifests a round's challenge window
still needs and ``release`` them when the round closes; a released
manifest that has been superseded by a newer version is garbage
collected, discarding the chunks no live manifest references.  The
latest version of every object is never collected.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.storage.chunks import (DEFAULT_CHUNK_BYTES, ChunkManifest,
                                  assemble_tree, build_manifest)
from repro_torch.storage.network import StorageNetwork


class ChunkUnavailableError(KeyError):
    """No healthy replica could produce a committed chunk."""

    def __init__(self, object_id: str, version: int, index: int, cid: str):
        super().__init__(cid)
        self.object_id = object_id
        self.version = version
        self.index = index
        self.cid = cid

    def __str__(self) -> str:
        return (f"chunk {self.index} ({self.cid[:12]}...) of "
                f"{self.object_id!r} v{self.version} unavailable on every "
                f"replica")


class ExpertStore:
    def __init__(self, network: StorageNetwork,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "storage.store"):
        self.network = network
        self.chunk_bytes = int(chunk_bytes)
        # object_id -> [(version, manifest_cid)], version-ascending
        self._versions: Dict[str, List[Tuple[int, str]]] = {}
        self._manifests: Dict[str, ChunkManifest] = {}    # by manifest cid
        self._refs: Dict[str, int] = {}                   # host retention
        self._chunk_refs: Dict[str, int] = {}             # live manifests
        self.stats = CounterGroup(
            {"versions": 0, "noop_versions": 0,
             "chunks_uploaded": 0, "chunks_deduped": 0,
             "uploaded_bytes": 0, "dedup_bytes": 0,
             "fetched_bytes": 0, "fetches": 0},
            metrics, namespace)

    # ------------------------------------------------------------ write
    def put_version(self, object_id: str, tree: Any,
                    version: int) -> ChunkManifest:
        """Publish one version of an object: upload only the chunks the
        network does not already hold; replace any manifest previously
        tagged at the same (object, version) — the honest-replay path
        after a chained rollback re-publishes the voided versions.

        Publishing content *identical* to what already serves this
        version tag is a no-op (the existing manifest is returned):
        re-publication never double-counts chunk references, and a
        rollback replay's full-bank republish creates no new version
        tags for experts the replay left unchanged."""
        manifest, chunks = build_manifest(object_id, version, tree,
                                          self.chunk_bytes)
        entries = self._versions.setdefault(object_id, [])
        serving = None
        for v, cid in entries:
            if v <= version:
                serving = cid
            else:
                break
        if serving is not None:
            cur = self._manifests.get(serving)
            if cur is not None and cur.chunk_cids == manifest.chunk_cids \
                    and cur.leaves == manifest.leaves:
                self.stats["noop_versions"] += 1
                return cur
        for cid, data in zip(manifest.chunk_cids, chunks):
            if self.network.has(cid):
                self.stats["chunks_deduped"] += 1
                self.stats["dedup_bytes"] += len(data)
            else:
                self.network.put(data)
                self.stats["chunks_uploaded"] += 1
                self.stats["uploaded_bytes"] += len(data)
            self._chunk_refs[cid] = self._chunk_refs.get(cid, 0) + 1
        self.network.put(manifest.to_json())
        mcid = manifest.manifest_cid
        self._manifests[mcid] = manifest
        replaced = [(v, c) for v, c in entries if v == version]
        entries[:] = [(v, c) for v, c in entries if v != version]
        entries.append((version, mcid))
        entries.sort()
        self.stats["versions"] += 1
        for _, old_cid in replaced:
            # a replaced manifest someone still retains (an open round
            # committed against it) keeps its bytes until released —
            # its auditors must fetch exactly what was committed, not
            # the replacement
            if old_cid != mcid and self._refs.get(old_cid, 0) == 0:
                self._drop_manifest(old_cid)
        # auto-GC: the version this one supersedes is collected as soon
        # as no host retains it (hosts without retention windows keep
        # only the latest version's bytes in the network)
        if len(entries) >= 2 and entries[-1][1] == mcid:
            prev_cid = entries[-2][1]
            if prev_cid != mcid and self._refs.get(prev_cid, 0) == 0:
                entries[:] = [(v, c) for v, c in entries if c != prev_cid]
                self._drop_manifest(prev_cid)
        return manifest

    # ------------------------------------------------------------ read
    def objects(self) -> List[str]:
        return sorted(self._versions)

    def contains(self, object_id: str, version: int = 0) -> bool:
        """Whether some manifest serves ``version`` of the object — the
        non-raising probe behind warm-prefix detection."""
        return any(v <= version
                   for v, _ in self._versions.get(object_id, []))

    def manifest_cid(self, object_id: str, version: int) -> str:
        """CID of the manifest serving ``version``: the newest one
        tagged at or before it."""
        entries = self._versions.get(object_id, [])
        best = None
        for v, cid in entries:
            if v <= version:
                best = cid
            else:
                break
        if best is None:
            raise KeyError(f"{object_id!r} has no version <= {version}")
        return best

    def manifest(self, object_id: str, version: int) -> ChunkManifest:
        return self._manifests[self.manifest_cid(object_id, version)]

    def manifest_by_cid(self, manifest_cid: str) -> ChunkManifest:
        if manifest_cid in self._manifests:
            return self._manifests[manifest_cid]
        # host-side index lost (fresh auditor): fetch the manifest object
        # from the network and verify it hashes back to its CID
        data = self.network.get(manifest_cid)
        manifest = ChunkManifest.from_json(data)
        if manifest.manifest_cid != manifest_cid:
            raise ValueError(f"manifest {manifest_cid[:12]}... does not "
                             f"hash to its CID")
        return manifest

    def fetch_manifest(self, manifest: ChunkManifest, like) -> Any:
        """Fetch + verify every chunk of a manifest and reassemble."""
        chunks: List[bytes] = []
        for i, cid in enumerate(manifest.chunk_cids):
            try:
                # network.get() hash-verifies every replica it serves, so
                # the returned bytes are already proven to match the CID
                # the manifest (and through its root, the chain) names
                data = self.network.get(cid)
            except KeyError as e:
                raise ChunkUnavailableError(manifest.object_id,
                                            manifest.version, i, cid) from e
            chunks.append(data)
        self.stats["fetches"] += 1
        self.stats["fetched_bytes"] += manifest.total_bytes
        return assemble_tree(manifest, chunks, like)

    def fetch(self, object_id: str, version: int, like) -> Any:
        return self.fetch_manifest(self.manifest(object_id, version), like)

    # -------------------------------------------------------- retention
    def retain(self, manifest_cid: str) -> None:
        self._refs[manifest_cid] = self._refs.get(manifest_cid, 0) + 1

    def release(self, manifest_cid: str) -> None:
        """Drop one retention ref; a superseded version nobody retains is
        garbage collected (manifest + the chunks only it references)."""
        refs = self._refs.get(manifest_cid, 0) - 1
        if refs > 0:
            self._refs[manifest_cid] = refs
            return
        self._refs.pop(manifest_cid, None)
        manifest = self._manifests.get(manifest_cid)
        if manifest is None:
            return
        entries = self._versions.get(manifest.object_id, [])
        if entries and entries[-1][1] == manifest_cid:
            return                      # latest version: never collected
        entries[:] = [(v, c) for v, c in entries if c != manifest_cid]
        self._drop_manifest(manifest_cid)

    def _drop_manifest(self, manifest_cid: str) -> None:
        manifest = self._manifests.pop(manifest_cid, None)
        if manifest is None:
            return
        for cid in manifest.chunk_cids:
            left = self._chunk_refs.get(cid, 0) - 1
            if left <= 0:
                self._chunk_refs.pop(cid, None)
                self.network.discard(cid)
            else:
                self._chunk_refs[cid] = left
        self.network.discard(manifest_cid)

    # ------------------------------------------------------- accounting
    def object_bytes(self, object_id: str,
                     version: Optional[int] = None) -> int:
        entries = self._versions.get(object_id, [])
        if not entries:
            return 0
        cid = (entries[-1][1] if version is None
               else self.manifest_cid(object_id, version))
        return self._manifests[cid].total_bytes

    def total_bytes(self) -> int:
        """Payload bytes of every object's latest version."""
        return sum(self.object_bytes(o) for o in self._versions)
