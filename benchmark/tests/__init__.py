"""CPU tests of the benchmark."""
