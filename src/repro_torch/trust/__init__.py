"""Trust primitives (ported from ``repro.trust``): Merkle commitments."""
