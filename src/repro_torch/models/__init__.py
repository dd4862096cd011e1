"""Model substrate: layers, single-rank MoE, block stack, language model."""
