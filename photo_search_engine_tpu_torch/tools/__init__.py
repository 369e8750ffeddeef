"""Operational tools: migration from reference-format indexes, recall
evaluation."""
