"""bmoe-paper — the paper's own MoE setup lifted to an LM-scale config:
N=10 experts, K=3 activated (paper §V: N=M=10, K=3), with B-MoE
redundancy enabled (faithful mode, r=2 by default).

This is the config used to demonstrate the paper's technique inside the
transformer framework; the paper's *original* MLP/CNN-expert experiments
live in ``repro_torch.core.bmoe``.  The redundancy vote runs on a mesh
with a ``replica`` axis (``core.trusted_moe.make_trust``).
"""
import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig, RedundancyConfig

CONFIG = ModelConfig(
    name="bmoe-paper",
    arch_type="moe",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2816,
    vocab_size=32768,
    block_pattern=(LayerSpec("attn", "moe"),),
    num_blocks=12,
    num_experts=10,            # N = 10 (paper)
    num_experts_per_tok=3,     # K = 3 (paper)
    num_shared_experts=0,
    moe_d_ff=2816,
    redundancy=RedundancyConfig(r=2, mode="faithful"),
    citation="[this paper, §V experiment setting]",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_blocks=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=256, vocab_size=512, num_experts=4,
    num_experts_per_tok=3, moe_d_ff=128,
    redundancy=RedundancyConfig(r=2, mode="faithful"))
