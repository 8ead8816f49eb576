"""Step checkpoints and integrity-checked serving artifacts."""
