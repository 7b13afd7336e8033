"""Weight conversion and checkpoints."""
