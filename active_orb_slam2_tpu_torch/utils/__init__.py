"""Utilities: host-side pose math, evaluation."""
