"""The B-MoE system core: ledger, attacks, experts and ``BMoESystem``."""
