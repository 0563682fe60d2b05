"""Diagnostic figures of the infer CLI."""
