"""Analytic cost model: MODEL_FLOPS and an HBM-traffic model per
(architecture x input shape), for the roofline's "useful compute" ratio
and its memory term (the counterpart of ``repro.launch.costmodel``; the
arithmetic is the JAX package's, line for line).

MODEL_FLOPS convention:
- train:   6 * N_active * tokens  (+ attention term 3.5 * 4*B*S*W*q_dim
           per attention layer; W = min(window, S), /2 if causal)
- prefill: 2 * N_active * tokens  (+ attention term 1x)
- decode:  2 * N_active * batch   (+ cache-attention term)

N_active counts routed experts at k/E of their parameters (MoE).

``HW`` holds one NVIDIA H100 SXM's published peaks (NVIDIA's data sheet,
dense rates, at the card's full 700 W power limit): 989 TFLOP/s bf16 on
the tensor cores, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s of HBM, 80 GB of it, and NVLink at 450 GB/s each way.
The compute peak is chosen per route, because the port runs float32:
library products (``torch.matmul``) run with TF32 off, so on the CUDA
cores at 67 TFLOP/s; the port's tensor-core kernels run 3xTF32 (three
TF32 products per float32 one), 495 / 3 = 165 TFLOP/s; bf16 operands
take 989.  ``ROUTE_PEAK`` maps ``launch.opanalysis``'s routes to them.
"""
from __future__ import annotations

from repro_torch.models.builder import count_params
from repro_torch.models.config import ModelConfig

HW = {
    "card": "NVIDIA H100 SXM, 700 W",
    "peak_flops_bf16": 989e12,      # dense bf16 tensor cores
    "peak_flops_tf32": 495e12,      # dense TF32 tensor cores
    "peak_flops_3xtf32": 495e12 / 3,  # one fp32 product as three TF32
    "peak_flops_fp32": 67e12,       # float32 outside the tensor cores
    "hbm_bw": 3.35e12,              # B/s
    "nvlink_bw": 450e9,             # B/s each way
    "hbm_per_chip": 80e9,           # B
}

ROUTE_PEAK = {
    "library_fp32": HW["peak_flops_fp32"],
    "library_bf16": HW["peak_flops_bf16"],
    "library_other": HW["peak_flops_fp32"],
    "kernel_3xtf32": HW["peak_flops_3xtf32"],
    "kernel_bf16": HW["peak_flops_bf16"],
}


def param_counts(cfg: ModelConfig) -> dict:
    from repro_torch.launch.shapes import param_decl
    total = count_params(param_decl(cfg))
    # routed-expert params (E experts, only k active per token)
    expert = 0
    specs = cfg.block_pattern + cfg.remainder
    n_moe = sum(1 for s in specs if s.mlp == "moe")
    if n_moe and cfg.num_experts:
        per_layer = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts
        n_moe_layers = (cfg.resolved_num_blocks *
                        sum(1 for s in cfg.block_pattern if s.mlp == "moe")
                        + sum(1 for s in cfg.remainder if s.mlp == "moe"))
        expert = per_layer * n_moe_layers
    active = total - expert
    if expert:
        active += expert * cfg.num_experts_per_tok / cfg.num_experts
    return {"total": total, "routed_expert": expert, "active": int(active)}


def _attn_layers(cfg: ModelConfig):
    out = []
    specs = (list(cfg.block_pattern) * cfg.resolved_num_blocks
             + list(cfg.remainder))
    for s in specs:
        if s.kind == "attn":
            out.append(0)                      # full attention
        elif s.kind == "local_attn":
            out.append(cfg.sliding_window)
    if cfg.is_encoder_decoder:
        out += [0] * cfg.num_encoder_layers    # encoder self-attn
        out += [-1] * cfg.num_layers           # cross-attn markers
    return out


def model_flops(cfg: ModelConfig, shape: dict) -> dict:
    B, S, kind = shape["batch"], shape["seq"], shape["kind"]
    pc = param_counts(cfg)
    if kind == "train":
        tokens, mult_mm, mult_attn = B * S, 6.0, 3.5
    elif kind == "prefill":
        tokens, mult_mm, mult_attn = B * S, 2.0, 1.0
    else:  # decode: one token per sequence
        tokens, mult_mm, mult_attn = B, 2.0, 1.0
    mm = mult_mm * pc["active"] * tokens
    attn = 0.0
    q_dim = cfg.q_dim
    for w in _attn_layers(cfg):
        if kind == "decode":
            span = S if w <= 0 else min(w, S)
        else:
            span = (S / 2 if w == 0 else min(w, S)) if w >= 0 else S
        attn += mult_attn * 4.0 * tokens * span * q_dim
    return {"matmul": mm, "attention": attn, "total": mm + attn,
            "params": pc}


def hbm_bytes(cfg: ModelConfig, shape: dict, num_devices: int,
              model_shards: int = 16) -> dict:
    """Per-device HBM traffic model (bytes / step).  bf16 params/acts,
    f32 optimizer state (the JAX package's model, kept so the two
    tables compare; the port's float32 run moves twice the bf16 bytes)."""
    B, S, kind = shape["batch"], shape["seq"], shape["kind"]
    pc = param_counts(cfg)
    p_local = pc["total"] / model_shards * 2          # bf16 param bytes
    data_shards = max(num_devices // model_shards, 1)
    b_local = max(B // data_shards, 1)
    d = cfg.d_model
    L = cfg.num_layers + cfg.num_encoder_layers

    if kind == "train":
        # weights fwd+bwd reads, grad write, AdamW m/v read+write (f32),
        # param read+write
        wbytes = p_local * (2 + 1) + (pc["total"] / model_shards) * (
            4 * 4 + 2 * 2)
        # remat: store+reload one residual per layer, recompute acts
        abytes = L * b_local * S * d * 2 * 3
        return {"total": wbytes + abytes, "weights": wbytes,
                "activations": abytes}
    if kind == "prefill":
        abytes = L * b_local * S * d * 2 * 2
        return {"total": p_local + abytes, "weights": p_local,
                "activations": abytes}
    # decode: weights + full KV-cache (or state) read per token
    cache = 0.0
    kv_bytes = 1 if getattr(cfg, "kv_cache_dtype", "") == "int8" else 2
    hd = cfg.resolved_head_dim
    specs = (list(cfg.block_pattern) * cfg.resolved_num_blocks
             + list(cfg.remainder))
    for s in specs:
        if s.kind == "attn":
            cache += kv_bytes * S * cfg.num_kv_heads * hd
        elif s.kind == "local_attn":
            cache += kv_bytes * min(cfg.sliding_window, S) * cfg.num_kv_heads * hd
        elif s.kind == "ssm":
            cache += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 2 * 2
        elif s.kind == "rglru":
            cache += cfg.rglru_expand * d * 2 * 2
    if cfg.is_encoder_decoder:
        cache += cfg.num_layers * kv_bytes * (S + 4096) * cfg.num_kv_heads * hd
    # k+v pair; caches shard over model (and data when B==1)
    cache_local = cache * b_local * 2 / model_shards
    return {"total": p_local + cache_local, "weights": p_local,
            "cache": cache_local}
