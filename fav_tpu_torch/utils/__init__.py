"""Weights bridge from the JAX package's flax trees."""
