"""Inference engine of the PyTorch port: paged KV, continuous batching,
the engine behind the ``submit_batch`` backend protocol."""
