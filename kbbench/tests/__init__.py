"""CPU tests of the benchmark harness (the card-only ones skip without a card)."""
