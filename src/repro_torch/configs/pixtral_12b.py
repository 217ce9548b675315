"""pixtral-12b — VLM: pixtral-ViT frontend (STUB: precomputed patch
embeddings) + mistral-nemo decoder backbone. [hf:mistralai/Pixtral-12B-2409]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    block_pattern=(LayerSpec("attn", "dense"),),
    num_blocks=40,
    frontend="vision",
    frontend_tokens=1024,     # patch embeddings per image (stub)
    train_microbatches=4,
    citation="[hf:mistralai/Pixtral-12B-2409]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    frontend_tokens=16)
