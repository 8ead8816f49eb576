"""Command-line entry points: ``launch.quantize`` and ``launch.serve``."""
