"""seamless-m4t-medium — audio enc-dec backbone (STUB audio frontend:
precomputed frame embeddings feed the encoder). [arXiv:2308.11596]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,            # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    block_pattern=(LayerSpec("attn", "dense"),),
    num_blocks=12,
    frontend="audio",
    citation="[arXiv:2308.11596]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, num_encoder_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512)
