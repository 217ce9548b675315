"""The LM stack's models: the decoder-only transformer, its MoE layer
(whose capacity dispatch the B-MoE system shares), the encoder-decoder,
and their layers, configs and declarations."""
