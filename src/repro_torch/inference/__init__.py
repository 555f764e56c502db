"""Inference layer of the PyTorch port: the engine (paged KV, continuous
batching) behind the ``submit_batch`` backend protocol, the calibrated
simulator, and the client stack in front of both (``CortexClient`` ->
``RequestPipeline`` -> ``Scheduler``)."""
