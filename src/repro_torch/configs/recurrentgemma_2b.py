"""recurrentgemma-2b — hybrid: RG-LRU recurrent blocks + local attention,
pattern (rglru, rglru, local_attn). [arXiv:2402.19427]"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

_PATTERN = (LayerSpec("rglru", "dense"), LayerSpec("rglru", "dense"),
            LayerSpec("local_attn", "dense"))

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=_PATTERN,
    num_blocks=8,
    remainder=(LayerSpec("rglru", "dense"), LayerSpec("rglru", "dense")),
    rglru_expand=1,
    train_microbatches=2,
    citation="[arXiv:2402.19427]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=256, num_heads=2, num_kv_heads=1,
    head_dim=64, d_ff=512, vocab_size=512, sliding_window=32,
    block_pattern=(LayerSpec("rglru", "dense"),
                   LayerSpec("local_attn", "dense")),
    num_blocks=1, remainder=())
