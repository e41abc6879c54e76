"""Evaluation-grid pieces of the port: the L1 analyzer pass over a corrupted batch."""
