"""Per-layer metric readers, one file per metric named as in
BENCHMARK.json: `read(facts)` returns the value, or None where the run
has nothing to read."""
