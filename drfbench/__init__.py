"""The benchmark of `repro_torch` on one H100: forests trained from seeded
rows, judged against a plain reference, timed and traced (see PERF.md)."""
