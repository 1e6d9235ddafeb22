"""Virtual clock, batch descriptors and device selection."""
