"""Serving runtime."""
