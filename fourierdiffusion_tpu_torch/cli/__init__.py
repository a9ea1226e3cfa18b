"""Command-line entry points: ``fdiff-torch-train`` and ``fdiff-torch-sample``."""
