"""The benchmark's own tests (CPU; the card-only case is marked ``cuda``)."""
