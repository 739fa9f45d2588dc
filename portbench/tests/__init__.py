"""CPU tests of the benchmark (and one card smoke, skipped without a card)."""
