"""smollm-360m — llama-arch small dense, GQA (kv=5).
[hf:HuggingFaceTB/SmolLM-135M]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    block_pattern=(LayerSpec("attn", "dense"),),
    num_blocks=32,
    citation="[hf:HuggingFaceTB/SmolLM-135M]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=240, num_heads=5,
    num_kv_heads=5, head_dim=48, d_ff=512, vocab_size=512)
