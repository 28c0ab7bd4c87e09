"""Traffic generators by kind: `<kind>.run(ctx)` drives one cell."""
