"""Synthetic LM data (``synthetic``)."""
