"""Model configurations (plain data) for the PyTorch port."""
