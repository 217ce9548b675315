"""qwen2-moe-a2.7b — MoE: 60 routed experts top-4 + 4 shared experts
(fused), moe_d_ff=1408. [hf:Qwen/Qwen1.5-MoE-A2.7B]

60 experts do not divide the 16-wide model axis, so the sharding rules
fall back to tensor parallelism inside each expert (moe_ff axis).  On
one card ``moe_impl="ep"`` means nothing, as in the JAX package without
a mesh; on a mesh (``launch.mesh.LMMesh``) its MoE layers run
expert-parallel (``models.moe_ep``), and the ``TRUSTED_*`` variants vote
over the mesh's ``replica`` axis."""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig, RedundancyConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,                 # shared-expert fused hidden (4 x 1408)
    vocab_size=151936,
    qkv_bias=True,
    block_pattern=(LayerSpec("attn", "moe"),),
    num_blocks=24,
    num_experts=60,
    padded_num_experts=64,   # pad to shard 64 experts over 16-wide model axis
    moe_impl="ep",           # shard_map all_to_all expert parallelism
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    train_microbatches=2,
    citation="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512, num_experts=4,
    num_experts_per_tok=2, num_shared_experts=1, moe_d_ff=128)

TRUSTED_FAITHFUL = dataclasses.replace(
    CONFIG, redundancy=RedundancyConfig(r=4, mode="faithful"))
TRUSTED_DIGEST = dataclasses.replace(
    CONFIG, redundancy=RedundancyConfig(r=4, mode="digest"))
