"""Model configuration, layers, the dense decoder and the parameter bridge."""
