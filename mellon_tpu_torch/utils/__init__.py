"""Validation and foundation utilities."""
