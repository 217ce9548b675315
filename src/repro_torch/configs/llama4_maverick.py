"""llama4-maverick-400b-a17b — MoE 128 routed experts top-1 + 1 shared
expert, GQA (kv=8), early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]

Native target of the paper's B-MoE technique: per-expert redundancy +
consensus vote.  The ``TRUSTED_*`` variants vote over a mesh's
``replica`` axis (``models.moe_ep``); at full width its MoE layers are
64 GB each in float32, so it runs only sharded."""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig, RedundancyConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    # Maverick interleaves dense and MoE layers 1:1 — 24 MoE layers of
    # 128 routed experts + shared expert => ~400B total / ~17B active
    block_pattern=(LayerSpec("attn", "dense"), LayerSpec("attn", "moe")),
    num_blocks=24,
    num_experts=128,
    moe_impl="ep",           # shard_map all_to_all expert parallelism
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    train_microbatches=4,
    citation="[hf:meta-llama/Llama-4-Scout-17B-16E]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=1, d_model=256, num_heads=4,
    train_microbatches=1,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, num_experts=4,
    moe_d_ff=256)

# paper-faithful trusted variants (r-way redundancy on expert outputs)
TRUSTED_FAITHFUL = dataclasses.replace(
    CONFIG, redundancy=RedundancyConfig(r=4, mode="faithful"))
TRUSTED_DIGEST = dataclasses.replace(
    CONFIG, redundancy=RedundancyConfig(r=4, mode="digest"))
