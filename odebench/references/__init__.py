"""Plain references of the configurations, one file each, found by name from BENCHMARK.json (manifest.module)."""
