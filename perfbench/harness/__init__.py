"""The benchmark's general code: specification files, weights, crops,
traffic, drivers, trace reading, arithmetic and the correctness check.
Only ``system.py`` imports the program under test."""
