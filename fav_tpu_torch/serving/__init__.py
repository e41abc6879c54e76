"""The decision-support app, its HTTP/WebSocket runtime, and the batched
analysis and inference services."""
