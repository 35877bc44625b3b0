"""Data-pipeline load balancing (document packing)."""
