"""Serving: one-token decode steps over a ring KV cache, and sampling."""
