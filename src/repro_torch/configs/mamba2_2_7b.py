"""mamba2-2.7b — attention-free SSM, SSD (state-space duality),
ssm_state=128. [arXiv:2405.21060]

The paper's expert-level redundancy technique is inapplicable (no routed
experts); implemented without it, as in the JAX package."""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,               # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(LayerSpec("ssm", "none"),),
    num_blocks=64,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    train_microbatches=4,
    citation="[arXiv:2405.21060]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, vocab_size=512,
    ssm_state=32, ssm_head_dim=32)
