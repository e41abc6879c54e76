"""Training data: CIFAR-10 or its deterministic synthetic stand-in."""
