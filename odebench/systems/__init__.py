"""Systems under test: how a configuration calls the port, one file each, found by name from BENCHMARK.json (manifest.module)."""
