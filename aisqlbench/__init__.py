"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): AISQL
queries from several tenants through its serving engine on one card."""
