"""Precision setting and synthetic scenes."""
