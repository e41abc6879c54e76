"""Serving of the port: the batched frame-analysis service."""
