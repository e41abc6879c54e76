"""Weights bridge from the JAX package's flax trees; latency histograms and stage timers."""
