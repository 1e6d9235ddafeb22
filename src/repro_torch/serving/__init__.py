"""Serving control plane (copied from ``repro.serving``) and the real-mode
runner that executes the model on the card."""
