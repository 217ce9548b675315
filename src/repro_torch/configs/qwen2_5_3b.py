"""qwen2.5-3b — dense, GQA (kv=2), QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=(LayerSpec("attn", "dense"),),
    num_blocks=36,
    train_microbatches=2,
    citation="[hf:Qwen/Qwen2.5-0.5B]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
