"""gemma3-27b — dense with 5:1 local:global attention, 128k context,
qk_norm. [hf:google/gemma-3-1b-pt]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

_L = LayerSpec("local_attn", "dense")
_G = LayerSpec("attn", "dense")

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    block_pattern=(_L, _L, _L, _L, _L, _G),
    num_blocks=10,
    remainder=(_L, _L),
    train_microbatches=8,
    citation="[hf:google/gemma-3-1b-pt]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    head_dim=64, d_ff=512, vocab_size=512, sliding_window=32,
    block_pattern=(_L, _G), num_blocks=1, remainder=())
