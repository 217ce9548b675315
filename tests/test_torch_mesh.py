"""B-MoE on the edge mesh (``BMoEConfig(mesh="on")``) in the port, on the
CPU: one world of 4 ranks over gloo (``launch.mesh.spawn_edges``) runs
every case of ``torch_mesh_ranks`` once, and each case is held to the
port's own ``mesh="off"`` system run in this process, bit for bit:
parameters, commitment roots, phases, fraud proofs, rollbacks, inference
logits, the ledger's block hashes.  These are the cases of
``tests/test_mesh_bmoe.py`` (the JAX package's mesh suite, which fails
under jax 0.9 with a ``ShardingTypeError``), at 4 shards.  The optimistic case starts from the
JAX package's init, so its parameters are also held to the JAX
``mesh="off"`` system at the parity tolerance (1e-5).

Ranks and oracle run on one intra-op thread each, so CPU bits do not
depend on threading; the world's rendezvous and collectives time out,
so a hung rank fails the test."""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core import bmoe as jbmoe
from repro.core.attacks import AttackConfig as JAttack
from repro.core.reputation import ReputationConfig as JRepCfg
from repro.trust import protocol as jproto
from repro_torch.core import bmoe
from repro_torch.launch import mesh as emesh
from repro_torch.trust.protocol import TrustConfig

WORLD = 4


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The optimistic case on the JAX package (``mesh="off"``): its init,
    carried into the port, and its parameters after the loop."""
    o = ranks.OPTIMISTIC
    sys_ = jbmoe.BMoESystem(jbmoe.BMoEConfig(
        framework="optimistic", dispatch="sparse", num_experts=8, top_k=2,
        capacity_factor=1.25, pow_difficulty=2,
        attack=JAttack(malicious_edges=(2,), attack_prob=1.0,
                       noise_std=5.0),
        reputation=JRepCfg(**ranks.REP),
        trust=jproto.TrustConfig(audit_rate=1.0, num_verifiers=2,
                                 challenge_window=2,
                                 audit_backend="batched")))
    assert o["num_experts"] == 8 and o["top_k"] == 2
    init = (jax.tree_util.tree_map(np.asarray, sys_.gate),
            jax.tree_util.tree_map(np.asarray, sys_.experts))
    xtr, ytr, _ = ranks.fmnist()
    rng = np.random.default_rng(0)
    for idx in [rng.integers(0, len(xtr), 48) for _ in range(5)]:
        sys_.train_round(xtr[idx], ytr[idx])
    sys_.flush_trust()
    return {"init": init,
            "bank": jax.tree_util.tree_map(np.asarray, sys_.experts),
            "gate": jax.tree_util.tree_map(np.asarray, sys_.gate),
            "rolled_back": sys_.protocol.stats["rolled_back"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_run, one_thread):
    """Every case with ``mesh="on"`` on 4 ranks; one result dict a rank."""
    out = tmp_path_factory.mktemp("edges")
    emesh.spawn_edges(ranks.edge_rank, WORLD, args=(str(out),
                                                    jax_run["init"]),
                      device="cpu", rendezvous_dir=str(out), timeout_s=240)
    res = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def oracle(jax_run, one_thread):
    """Every case with ``mesh="off"``, in this process."""
    return {name: ranks.run_case(name, "off", jax_run["init"]
                                 if name == "optimistic" else None)
            for name in ranks.CASES if name != "wire"}


def _same_params(got, want):
    return got["bank"] == want["bank"] and got["gate"] == want["gate"]


# ------------------------------------------------------- in-process
def test_mesh_config_validation():
    with pytest.raises(ValueError, match="sparse"):
        bmoe.BMoESystem(bmoe.BMoEConfig(framework="optimistic",
                                        dispatch="dense", mesh="on"),
                        device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        bmoe.BMoESystem(bmoe.BMoEConfig(mesh="ring"), device="cpu")
    # without a process group the edge mesh is one shard, as JAX's is on
    # one device, and the system still constructs
    s = bmoe.BMoESystem(bmoe.BMoEConfig(
        framework="optimistic", dispatch="sparse", mesh="on",
        num_experts=8, top_k=2, pow_difficulty=2,
        trust=TrustConfig(audit_rate=0.5, num_verifiers=1,
                          challenge_window=1)), device="cpu")
    assert s.mesh_shards == 1 and s.mesh.group is None
    assert s.experts["w1"].shape[0] == 8
    with pytest.raises(ValueError, match="divide the device count"):
        emesh.make_edge_mesh(8, shards=4, device="cpu")
    assert emesh._model_width(8, divides=6) == 2
    assert emesh._model_width(5, divides=10) == 5
    assert emesh.edge_backend("cpu", 4) == "gloo"


def test_one_shard_mesh_is_the_one_device_system(one_thread):
    """The mesh path with one shard (its exchanges the identity) is the
    ``mesh="off"`` system bit for bit, block hashes included."""
    a, b = (ranks.run_case("optimistic", m, shards=None)
            for m in ("off", "on"))
    assert b["num_shards"] == 1 and _same_params(a, b)
    assert a["rounds"] == b["rounds"] and a["logits"] == b["logits"]
    assert a["host"] == b["host"]


def test_edge_mesh_exchanges_on_one_shard():
    m = emesh.make_edge_mesh(4, device="cpu")
    x = torch.arange(12.0).reshape(1, 3, 4).requires_grad_()
    y = m.all_to_all(x, "dispatch")
    assert torch.equal(y, x)
    rows = m.slice_rows(x[0], 3)
    assert torch.equal(rows, x[0])
    full = m.gather_rows(rows * 2, 3, 3)
    assert torch.equal(full, 2 * x[0])
    full.sum().backward()
    assert torch.equal(x.grad[0], torch.full((3, 4), 2.0))
    assert m.all_gather(x[0]).shape == (1, 3, 4)
    assert m.row_range(3, 3) == (0, 3) and m.expert_range(4) == (0, 4)
    assert m.wire_bytes == {}


# ---------------------------------------------------------- the world
def test_mesh_off_holds_one_shard_inside_a_world(world):
    """``mesh="off"`` built by a rank of a world still runs on one device:
    its mesh is one shard with no process group, its exchanges the
    identity (they send nothing)."""
    assert all(r["off_mesh"] == (1, True, {}) for r in world)


def test_mesh_rejects_non_pow2_shard_leaves(world):
    """(num_experts/shards) * chunks_per_expert must be a power of two
    for the root-of-roots reduction to be the flat root: E=6 on 2 shards
    with 3 chunks (9 leaves a shard) is refused at construction."""
    for res in world:
        assert res["non_pow2"] is not None
        assert "power-of-two" in res["non_pow2"]


def test_mesh_optimistic_round_loop_bit_identical(world, oracle):
    """5 attacked optimistic rounds, audits, slash and rollback on 4 edge
    shards against the one-device system: parameters, roots, phases,
    fraud proofs, rollbacks, logits, and the per-shard audit rows."""
    want = oracle["optimistic"]
    for res in world:
        got = res["optimistic"]
        assert _same_params(got, want)
        assert got["rounds"] == want["rounds"]
        assert got["flush"] == want["flush"]
        assert got["logits"] == want["logits"]
        assert got["num_shards"] == 4 and got["shard_roots_reduce"]
        assert got["rolled_back"] == want["rolled_back"] >= 1
    rows = world[0]["optimistic"]["audit_rows"]
    total = sum(rows.values())
    assert total > 0 and all(r > 0 for r in rows.values()), rows
    # audit_rate=1 samples every leaf: each shard recomputes about a
    # quarter of the rows, within one capacity bucket (16 slots)
    assert max(rows.values()) <= total / 4 + 16, rows
    assert all(r["optimistic"]["audit_rows"] == rows for r in world)


@pytest.mark.parametrize("framework", ["traditional", "bmoe"])
def test_mesh_frameworks_bit_identical(world, oracle, framework):
    """Per-edge corruption (traditional) and the redundancy vote over the
    local experts (bmoe) at 4 shards of 2 experts: parameters, attacked
    inference logits and supports bitwise the one-device system's."""
    want = oracle[framework]
    for res in world:
        got = res[framework]
        assert _same_params(got, want)
        assert got["logits"] == want["logits"]
        assert got["support"] == want["support"]


def test_mesh_bank_actually_sharded(world):
    """Each rank's device holds only its E/shards = 2 bank rows."""
    for res in world:
        assert res["optimistic"]["local_rows"] == {
            "b1": (2, 256), "b2": (2, 10), "w1": (2, 784, 256),
            "w2": (2, 256, 10)}


def test_mesh_replicas_agree(world, oracle):
    """2 shards x 2 data replicas: both replicas of both shards hold the
    one-device system's parameters and logits."""
    want = oracle["replicas"]
    for res in world:
        got = res["replicas"]
        assert _same_params(got, want) and got["logits"] == want["logits"]


def test_mesh_cnn_round_bit_identical(world, oracle):
    """One optimistic round of the CIFAR-10 CNN bank (an attacking
    executor, convicted and replayed in the flush) on 4 shards of one
    expert."""
    want = oracle["cnn"]
    for res in world:
        got = res["cnn"]
        assert _same_params(got, want) and got["logits"] == want["logits"]
        assert got["host"]["stats"]["rolled_back"] == 1


def test_mesh_host_state_equal_on_every_rank(world, oracle):
    """Host state is replicated: every rank's chain (block hashes), the
    protocol's counters, the stake book, reputation and the storage
    counters are equal, and equal to the one-device system's."""
    for name in ("optimistic", "traditional", "bmoe", "replicas", "cnn"):
        for res in world:
            assert res[name]["host"] == world[0][name]["host"], name
        assert world[0][name]["host"] == oracle[name]["host"], name
    assert world[0]["optimistic"]["host"]["stats"]["committed"] == 5


def test_mesh_carried_matches_jax(world, jax_run):
    """The optimistic loop from JAX's init ends, after its rollback, on
    the JAX ``mesh="off"`` system's parameters at 1e-5."""
    got = world[0]["optimistic"]
    assert got["rolled_back"] == jax_run["rolled_back"] >= 1
    for tree, want in (("bank_np", jax_run["bank"]),
                       ("gate_np", jax_run["gate"])):
        for k, v in want.items():
            np.testing.assert_allclose(got[tree][k], v, rtol=0, atol=1e-5)


def test_mesh_dispatch_bytes_independent_of_experts(world):
    """Each rank's dispatch bytes at E=16 stay within 1.25x of E=8 at the
    same batch: the send buffer is the capacity buckets, about
    capacity_factor*B*top_k rows, whatever the expert count."""
    for res in world:
        w8, w16 = res["wire"][8], res["wire"][16]
        assert w8["dispatch"] > 0 and w8["return"] > 0
        assert w16["dispatch"] <= 1.25 * w8["dispatch"]
        assert w16["return"] <= 1.25 * w8["return"]


def test_spawn_edges_fails_when_a_rank_fails(tmp_path):
    """Rank 1 raises: the world fails (the error reported may be rank 1's
    own or rank 0's broken barrier, whichever the join sees first)."""
    import torch.multiprocessing as mp
    with pytest.raises(mp.ProcessRaisedException):
        emesh.spawn_edges(ranks.failing_rank, 2, device="cpu",
                          rendezvous_dir=str(tmp_path), timeout_s=60)
