"""Shared utilities: problem generators."""
