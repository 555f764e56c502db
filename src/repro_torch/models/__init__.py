"""Model zoo of the PyTorch port: primitives, attention, blocks, LM."""
