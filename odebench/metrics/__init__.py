"""Per-layer metric readers, one file each, found by name from BENCHMARK.json (manifest.module)."""
