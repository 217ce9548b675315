"""qwen3-32b — dense, GQA (kv=8), qk_norm. [hf:Qwen/Qwen3-8B]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=(LayerSpec("attn", "dense"),),
    num_blocks=64,
    train_microbatches=8,
    citation="[hf:Qwen/Qwen3-8B]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512)
