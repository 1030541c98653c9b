"""Per-layer metric readers, one file each: ``<metric name>.py``."""
