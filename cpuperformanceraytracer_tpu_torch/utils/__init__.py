"""Timing utilities."""
