"""Models of the port: the failure-aware CNN and its uncertainty scalars."""
