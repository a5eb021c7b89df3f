"""Tiered, content-addressed KV/context-state cache (the paper's storage half)."""
