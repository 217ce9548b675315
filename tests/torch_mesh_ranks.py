"""The cases of ``tests/test_torch_mesh.py``, importable by the ranks
``spawn_edges`` starts (a spawned process cannot import a test file).

``run_case(name, mesh, ...)`` builds the case's ``BMoESystem`` with
``mesh="on"`` or ``"off"`` on the CPU, drives it, and returns what the
test compares: parameter digests over the whole bank, commitment roots,
phases, fraud proofs, inference logits as bytes, host-state digests.
A rank calls it with ``mesh="on"`` inside its world (``edge_rank``
writes every case's results to ``<out>/rank<r>.pkl``); the test calls it
with ``mesh="off"`` in its own process, the one-device oracle."""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.bmoe import BMoEConfig, BMoESystem
from repro_torch.core.ledger import as_numpy, digest_tree
from repro_torch.core.reputation import ReputationConfig
from repro_torch.data.synthetic import CIFAR10, FMNIST, make_image_dataset
from repro_torch.trust.commitments import MerkleTree
from repro_torch.trust.protocol import TrustConfig

REP = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)
# the attacked optimistic loop of tests/test_mesh_bmoe.py at 4 shards
OPTIMISTIC = dict(
    framework="optimistic", num_experts=8, top_k=2, capacity_factor=1.25,
    pow_difficulty=2,
    attack=AttackConfig(malicious_edges=(2,), attack_prob=1.0,
                        noise_std=5.0),
    reputation=ReputationConfig(**REP),
    trust=TrustConfig(audit_rate=1.0, num_verifiers=2, challenge_window=2,
                      audit_backend="batched"))
CASES = ("optimistic", "traditional", "bmoe", "replicas", "cnn", "wire")


def fmnist():
    xtr, ytr, xte, _ = make_image_dataset(FMNIST, n_train=600, n_test=100,
                                          seed=0)
    return xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1)


def _host_state(s: BMoESystem) -> Dict:
    """What every rank must hold alike: the chain, the protocol's
    counters, the stake book, reputation and the storage counters."""
    out = {"blocks": [b.hash for b in s.ledger.blocks],
           "storage": s.storage_report()["network"],
           "store": s.storage_report()["store"]}
    if s.protocol is not None:
        out["stats"] = dict(s.protocol.stats)
        out["stakes"] = [(ev.edge, ev.round_id) for ev in
                         s.protocol.stakes.events]
        out["excluded"] = s.reputation.excluded.tolist()
    return out


def _params(s: BMoESystem) -> Dict:
    bank = s.full_bank()
    return {"bank": digest_tree(bank), "gate": digest_tree(s.gate),
            "bank_np": {k: as_numpy(v) for k, v in bank.items()},
            "gate_np": {k: as_numpy(v) for k, v in s.gate.items()}}


def run_case(name: str, mesh: str, params=None,
             shards: Optional[int] = 4) -> Optional[Dict]:
    """One case on the CPU; ``params`` (numpy gate and bank) replaces the
    seeded init of the optimistic case (the JAX package's, carried), and
    ``shards`` its ``mesh_shards``."""
    xtr, ytr, xte = fmnist()
    if name == "optimistic":
        p = None if params is None else params_from_numpy(*params,
                                                          device="cpu")
        s = BMoESystem(BMoEConfig(mesh=mesh, **dict(OPTIMISTIC,
                                                    mesh_shards=shards)),
                       device="cpu", params=p)
        rng = np.random.default_rng(0)
        for idx in [rng.integers(0, len(xtr), 48) for _ in range(5)]:
            s.train_round(xtr[idx], ytr[idx])
        flush = s.flush_trust()
        rounds = {rid: (st.commitment.root, st.phase.value,
                        [(p.leaf_index, p.expert, p.claimed_digest,
                          p.recomputed_digest) for p in st.proofs])
                  for rid, st in s.protocol.rounds.items()}
        com = s.protocol.rounds[0].commitment
        return {**_params(s), "rounds": rounds, "flush": flush,
                "num_shards": com.num_shards,
                "shard_roots_reduce": (com.shard_roots is None
                                       or MerkleTree(com.shard_roots).root
                                       == com.root),
                "rolled_back": s.protocol.stats["rolled_back"],
                "logits": s.infer(xte[:64], commit=False)[0].tobytes(),
                "audit_rows": {sh: s.obs.metrics.value(
                    "bmoe.mesh.audit_rows", shard=str(sh))
                    for sh in range(4)},
                "local_rows": {k: tuple(v.shape)
                               for k, v in s.experts.items()},
                "host": _host_state(s)}
    if name in ("traditional", "bmoe", "replicas"):
        fw = "bmoe" if name == "replicas" else name
        s = BMoESystem(BMoEConfig(
            framework=fw, mesh=mesh, num_experts=8, top_k=2,
            pow_difficulty=2, mesh_shards=2 if name == "replicas" else 4,
            attack=AttackConfig(malicious_edges=(1, 2), attack_prob=1.0,
                                noise_std=3.0)), device="cpu")
        for r in range(3):
            s.train_round(xtr[r * 48:(r + 1) * 48], ytr[r * 48:(r + 1) * 48])
        logits, _, support = s.infer(xte[:32])
        return {**_params(s), "logits": logits.tobytes(),
                "support": support.tobytes(), "host": _host_state(s)}
    if name == "cnn":
        x, y, _, _ = make_image_dataset(CIFAR10, n_train=32, n_test=1,
                                        seed=0)
        s = BMoESystem(BMoEConfig(
            framework="optimistic", mesh=mesh, num_experts=4, num_edges=4,
            top_k=2, expert_kind="cnn", in_ch=3, lr=0.1, pow_difficulty=1,
            mesh_shards=4,
            attack=AttackConfig(malicious_edges=(0,), attack_prob=1.0,
                                noise_std=5.0),
            trust=TrustConfig(audit_rate=1.0, challenge_window=1,
                              chunks_per_expert=2)), device="cpu")
        s.train_round(x[:16], y[:16])
        s.flush_trust()
        return {**_params(s), "logits": s.infer(x[16:], commit=False)[0]
                .tobytes(), "host": _host_state(s)}
    if name == "wire":
        # per-rank dispatch bytes of one bmoe round at E=8 and E=16
        out = {}
        for n in (8, 16):
            s = BMoESystem(BMoEConfig(framework="bmoe", mesh=mesh,
                                      num_experts=n, top_k=2,
                                      pow_difficulty=2, mesh_shards=4),
                           device="cpu")
            s.train_round(xtr[:48], ytr[:48])
            out[n] = dict(s.mesh.wire_bytes)
        return out
    raise ValueError(name)


def edge_rank(rank: int, world: int, out_dir: str, params) -> None:
    """A rank of the test's world: every case with ``mesh="on"``, the
    non-power-of-two refusal, and the results to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    res = {name: run_case(name, "on", params if name == "optimistic"
                          else None) for name in CASES}
    try:
        BMoESystem(BMoEConfig(
            framework="optimistic", mesh="on", num_experts=6, top_k=2,
            mesh_shards=2, pow_difficulty=2,
            trust=TrustConfig(audit_rate=0.5, num_verifiers=1,
                              challenge_window=1, chunks_per_expert=3)),
            device="cpu")
        res["non_pow2"] = None
    except ValueError as e:
        res["non_pow2"] = str(e)
    # mesh="off" inside the world: a one-shard mesh of its own
    off = BMoESystem(BMoEConfig(num_experts=4, top_k=2), device="cpu").mesh
    res["off_mesh"] = (off.shards, off.group is None, off.wire_bytes)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def failing_rank(rank: int, world: int) -> None:
    """A world whose rank 1 raises: ``spawn_edges`` must fail."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def card_case(framework: str, mesh: str) -> Dict:
    """The card test's runs on the CUDA device: 4 experts on 2 shards, 3
    rounds of 64 (``bmoe`` under 3 colluders; ``optimistic`` with edge 1
    cheating, every leaf audited, then ``flush_trust``) and ``infer``."""
    xtr, ytr, xte = fmnist()
    kw = dict(framework=framework, mesh=mesh, mesh_shards=2, num_experts=4,
              top_k=2, pow_difficulty=2)
    if framework == "optimistic":
        kw.update(attack=AttackConfig(malicious_edges=(1,), attack_prob=1.0,
                                      noise_std=5.0),
                  reputation=ReputationConfig(**REP),
                  trust=TrustConfig(audit_rate=1.0, challenge_window=1))
    else:
        kw.update(attack=AttackConfig(malicious_edges=(7, 8, 9),
                                      attack_prob=1.0, noise_std=5.0))
    s = BMoESystem(BMoEConfig(**kw), device="cuda")
    for r in range(3):
        s.train_round(xtr[r * 64:(r + 1) * 64], ytr[r * 64:(r + 1) * 64])
    s.flush_trust()
    logits = s.infer(xte[:64], commit=framework != "optimistic")[0]
    out = {**{k: v for k, v in _params(s).items() if not k.endswith("_np")},
           "logits": logits.tobytes(), "host": _host_state(s)}
    if s.protocol is not None:
        out["roots"] = [st.commitment.root
                        for st in s.protocol.rounds.values()]
    return out


def card_rank(rank: int, world: int, out_dir: str) -> None:
    """A rank of the card test's world: both frameworks on the mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {fw: card_case(fw, "on") for fw in ("bmoe", "optimistic")}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
